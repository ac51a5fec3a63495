#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``lizardfs_tpu_torch``) on one NVIDIA card.

Run from the root of the repository: ``python3 chip_smoke.py``. It

1. prints the card (``nvidia-smi``) and the torch/CUDA versions, and
   exits non-zero without a CUDA device;
2. builds the kernels from ``lizardfs_tpu_torch/ops/csrc/``; the
   build passes ``nvcc -Xptxas -v``'s registers, shared memory and
   spills of each kernel through to standard error;
3. holds each of the four kernels byte for byte against its plain
   PyTorch version on the card, and one shape of each against the numpy
   golden path, at the ec(8,4) 64 MiB chunk shapes and at the other
   geometries' edges (output row groups of one and three, the largest
   tables at ec(32,32), small and ragged blocks);
4. runs the main path through the entry points a user calls: a 64 MiB
   chunk striped at ec(8,4), encoded and checksummed, one part and then
   four parts lost and rebuilt, checksummed and verified, and the chunk
   reassembled byte-identically, with every kernel's launch counter
   read around that run;
5. runs the multi-device path over a mesh of every visible card:
   ``dryrun_multichip`` (ec(32,8) over a 64 MiB logical chunk of 64 KiB
   blocks, encoded, one part killed and rebuilt, against the golden
   codec), ``ShardedCudaChunkEncoder`` rebuilding one and then eight
   parts of that chunk and a geometry its guard keeps on one card, and
   the encoder registry's one object per name; the ``encode`` and
   ``block_crcs`` counters and the mesh-recover counter are read around
   it;
6. runs the chunkserver's rebuild path at ec(8,4) (the goal from
   ``load_goal_config("10 fast : $ec(8,4)")``), 64 MiB chunks of 64 KiB
   blocks, on disk: ``encode_with_checksums`` writes the twelve parts
   into one ``ChunkStore`` per server (each card CRC checked against
   zlib by the store), part 3 is deleted and rebuilt by ``rebuild_part``
   with ``replicator_encoder``'s encoder (its file, bytes and CRC slots
   against the originals), a degraded read-modify-write read of a short
   chunk runs with part 3 missing (in the middle and at the zero-padded
   tail, then with a wave-0 source failing so a fallback wave fires), and
   an xor3 part and a std copy are rebuilt; the ``encode`` and
   ``block_crcs`` counters are read around it, and it prints the
   encoder the ladder chose, how many kernel calls got rows off a
   16-byte boundary, and the host-clock split of ``rebuild_part``
   (median of 5);
7. runs the chunkserver on the wire at ec(8,4): thirteen port
   ``ChunkServer``s on ephemeral localhost ports, each with its own data
   folder and the card's encoder; the twelve parts of a 64 MiB chunk
   (less 3 blocks and 1000 bytes) encoded by ``encode_with_checksums``
   and written to twelve of them over the wire (``CltocsWriteInit``,
   one ``CltocsWriteData`` a block carrying the card's block CRC, which
   each server checks against zlib, ``CltocsWriteEnd``); a std part
   relayed down a two-server chain; the whole chunk read back with
   ``read_part_range``; part 3's server stopped and a ``SliceReadPlanner``
   plan for data parts 0-7, blocks 5-41, run by ``execute_plan`` over the
   eleven live servers (recovery through the card); part 3 rebuilt by
   ``_cmd_replicate`` on the thirteenth server from the other eleven
   (its file, bytes and CRC slots against the write's); the ``encode``
   and ``block_crcs`` counters set to 0 before the degraded read and
   read after the rebuild, the encoder the replicator chose, the count of
   wrapper calls on offset rows, and host-clock times (median of 3) of
   the wire write, the whole read, the degraded read and
   ``_cmd_replicate`` with its split (``plan_rebuild``, ``execute_plan``
   and its ``recover``, ``write_rebuilt`` and its ``checksum``);
8. runs a whole cluster as a user does, at the shipped goal: one port
   ``MasterServer`` (``SHIPPED_GOALS``), thirteen port ``ChunkServer``s
   on the card's encoder and one port ``Client`` on ``get_encoder(None)``
   (``cuda`` on one card), in this process on localhost ports; a file of
   two 64 MiB chunks, 1 MiB and 4242 bytes written through the master's
   grants (three times, the first counted), read back whole (three
   times), read degraded (three times) with a holder of a data part of
   chunk 0 stopped and the master's rebuilds held back, then the
   master's health loop rebuilding every lost part; chunk 0's rebuilt
   part against the numpy golden bytes and CRCs, and the file read
   once more. The counters are set to 0 before the write, the read, the
   degraded read and the rebuild and read after each (``encode`` at
   least once a chunk in the write and once in the degraded read and
   the rebuild, ``block_crcs`` at least once in the rebuild). It prints
   a ``cluster_ec8_4`` line: host-clock medians of the write (and MiB/s,
   and the client's write phases), the read and the degraded read; the
   time the master took to see the server go and to heal, with the
   rebuilds' split summed over them; the kernels' and the copies' device
   time (``torch.profiler``) in one more write and in the heal, as a
   share of each; and two ``profile`` lines of the sampler;
9. runs the front doors over a cluster built as in 8: the file (a
   64 MiB chunk, 1 MiB and 4242 bytes) written three times and read
   three times through each of a FUSE mount's ctypes callbacks
   (``LizardFuse``, no kernel mount; ``create``/``open``, ``write`` in
   1 MiB pieces, ``flush``, ``release``, ``read``, ``getattr``,
   ``readdir``, then ``.masterinfo`` and one master call through the
   mount's proxy), the NFSv3 gateway (UNSTABLE ``WRITE``s of its 1 MiB
   ``wtmax``, ``COMMIT``, ``READ``s) and the S3 gateway (``PUT``,
   ``GET``, and a three-part multipart upload of the same bytes); the S3
   object demoted to a port ``TapeServer`` and recalled by a ``GET``;
   each door's file read three times more with holders of a data part
   of every file's chunk 0 stopped and the master's rebuilds held back,
   then the master's heal. Every read is byte-exact; the counters are
   set to 0 before and read after each step (``encode`` at least once
   a chunk in each door's first write and in the recall, at least once
   in each degraded read, ``block_crcs`` at least once in the heal), and
   every door's client runs on the card's encoder. It prints one
   ``frontdoor_<door>_ec8_4`` line a door (host-clock medians of the
   write, with MiB/s, the read and the degraded read; the kernels' and
   copies' device time in one more write, from ``torch.profiler``, as a
   share of it; the launches) and a ``frontdoor_tape_recall_ec8_4`` line
   (the demote, the recalling GET, the heal);
10. runs failover on the card: a port master, its shadow and a port
   ``Metalogger`` in a three-node quorum wired as the entry points wire
   it (a ``FailoverController`` on each master, a vote-only
   ``ElectionNode`` on the metalogger; election timeout
   ``FAILOVER_ELECTION_TIMEOUT``, heartbeat ``FAILOVER_HEARTBEAT``) over
   thirteen chunkservers with both master addresses at the shipped
   goal; the file (a chunk, 1 MiB and 4242 bytes) written by the port's
   ``lizardfs put`` (``tools.cli.main``, its client on the card), the
   shadow and the metalogger caught up, the active master and its
   controller stopped, the shadow elected and promoted (exactly once,
   after the kill), every server registered again; a holder of a data
   part of chunk 0 stopped with the new master's rebuilds held back and
   the file read degraded by ``lizardfs get``, ``lizardfs cat`` and a
   ``Client`` on both addresses, then the new master's heal (chunk 0's
   rebuilt part against the numpy golden bytes and CRCs) and one more
   read; ``lizardfs-admin metadata-checksum`` of the new master against
   a ``metarestore`` of the metalogger's archive, and ``metadump`` of
   it. The counters are set to 0 before and read after each step
   (``encode`` at least once a chunk in the write and once in each
   degraded read and the heal, ``block_crcs`` in the heal). It prints a
   ``failover_ec8_4`` line: the write (and MiB/s), kill to promotion
   (``last_promotion_at``), kill to a client's first reply from the new
   master, kill to every server registered again, the degraded reads'
   median, the heal, the elections and promotions, the launches;
11. times each kernel and its plain version with CUDA events, the CRC
   wrappers on rows off a 16-byte boundary, the encoder's write and
   one-part rebuild end to end (numpy in and out) at ec(8,4), and the
   ec(32,8) wide-stripe encode and rebuild on the mesh beside one card's
   encoder, and prints one JSON line per kernel and per path, the card,
   and a ``{"kernels": [...]}`` line;
12. ends with ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the script exits non-zero.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import logging
import re
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np

K, M = 8, 4  # the shipped ec(8,4) goal
BS = 64 * 1024  # MFSBLOCKSIZE
CHUNK = 64 * 2**20  # MFSCHUNKSIZE
PART = CHUNK // K  # 8 MiB data / parity parts
ODD_N = 1_000_003  # a degraded-read length that is no multiple of anything
SEED = 1234
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate
SCALAR_OPS_PER_S = 67e12  # H100 SXM 32-bit CUDA-core rate (float32; integer is no faster)
CRC_OPS_PER_BYTE = 3  # slicing-by-8: a byte extract, a table load and an XOR per byte
WINDOW_MS = 50.0  # each timing window lasts at least this long
WINDOWS = 5  # timings report the median window
SOURCE = "lizardfs_tpu_torch/ops/csrc/ec_kernels.cu"
SASS = {  # kernel: pattern of its (mangled) name in cuobjdump's listing
    "fused_encode_crc_kernel": "fused_encode_crc_kernel",
    "crc_fold_kernel": "crc_fold_kernel",
    "gf_apply_kernel<true>": "gf_apply_kernelILb1E",
    "gf_apply_kernel<false>": "gf_apply_kernelILb0E",
    "block_crc_kernel": "block_crc_kernel",
}
WIDE_K, WIDE_M = 32, 8  # the wide stripe of the multi-device path
WIDE_LOST = [0, 5, 9, 16, 31, 33, 36, 39]  # eight parts of ec(32,8), data and parity
SHIPPED_GOALS = "10 fast : $ec(8,4)"  # README.md's goals.cfg line
SHORT_CHUNK = CHUNK - 3 * BS - 1000  # trailing parts short: zero-padded on read
LOST = 3  # the part the rebuild phase loses
RMW_BLOCKS = (5, 37)  # first block and block count of the degraded read
CLUSTER_BYTES = 2 * CHUNK + 2**20 + 4242  # the cluster phase's file: two chunks and a tail
CLUSTER_REPS = 3  # timed writes and reads of the cluster phase
FRONTDOOR_BYTES = CHUNK + 2**20 + 4242  # each door's file: a chunk and a tail
FRONTDOOR_REPS = 3  # timed writes and reads of each door
FRONTDOOR_PIECE = 2**20  # FUSE and NFS write and read size (the gateway's wtmax)
FAILOVER_BYTES = FRONTDOOR_BYTES  # the failover phase's file
# the failover phase's election timing: wider than the entry point's
# defaults (0.15-0.30 s, heartbeat 0.05 s), since every daemon shares
# this process's one event loop and a busy write must not starve the
# active's heartbeats into an election
FAILOVER_ELECTION_TIMEOUT = (2.0, 4.0)
FAILOVER_HEARTBEAT = 0.1
FAILOVER_PROMOTION_S = 30.0  # the bound on kill -> promotion
REPLACES = {
    "encode": "lizardfs_tpu/ops/pallas_ec.py:108",
    "block_crcs": "lizardfs_tpu/ops/pallas_ec.py:166",
    "fused_encode_crc": "lizardfs_tpu/ops/pallas_ec.py:527",
    "fused_decode_verify": "lizardfs_tpu/ops/pallas_ec.py:590",
}


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def sass_mix(library: str, kernel: str) -> dict | None:
    """Instruction counts of one kernel in the built library, from
    ``cuobjdump -sass``: all, by opcode (the 12 most frequent), and of
    each loop (a backward branch) in code order. None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", library], capture_output=True,
                              text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    body = re.search(r"Function : \S*" + kernel + r"(.*?)(?=\n\s*Function :|\Z)", sass, re.S)
    if body is None:
        return None
    code = re.findall(r"/\*([0-9a-f]{4})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*)",
                      body.group(1))
    ops = collections.Counter(op.split(".")[0] for _, op, _ in code)
    loops = []
    for addr, op, args in code:
        target = re.match(r"0x([0-9a-f]+)", args.strip())
        if op.startswith("BRA") and target and int(target.group(1), 16) < int(addr, 16):
            loops.append((int(addr, 16) - int(target.group(1), 16)) // 16 + 1)
    return {"instructions": len(code), "ops": dict(ops.most_common(12)), "loops": loops}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2

    from lizardfs_tpu_torch.core import geometry
    from lizardfs_tpu_torch.core.encoder import CpuChunkEncoder, get_encoder
    from lizardfs_tpu_torch.entry import entry
    from lizardfs_tpu_torch.models import flagship
    from lizardfs_tpu_torch.ops import _build, crc32, cuda_ec, gf256, rs, torch_ec
    from lizardfs_tpu_torch.utils import striping

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: exact fp32
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)

    # -- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.3f} s ({_build.library_path().name})")
    for kernel, pattern in SASS.items():
        print(json.dumps({"sass": kernel, **(sass_mix(str(_build.library_path()), pattern) or {})}))

    # -- phase 2: each kernel against its plain version and the golden ----
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand_bytes(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)

    def u32(t):  # int32 CRC bits -> int64 uint32 values
        return t.to(torch.int64) & 0xFFFFFFFF

    err = {name: 0 for name in REPLACES}

    def same(name, got, want, what, crc=False):
        a, b = (u32(got), u32(want)) if crc else (got.to(torch.int64), want.to(torch.int64))
        diff = int((a - b).abs().max()) if a.numel() else 0
        err[name] = max(err[name], diff)
        require(a.shape == b.shape and diff == 0, f"{name}: {what}")

    bigm = torch.from_numpy(torch_ec.encoding_bitmatrix(K, M)).to(dev)
    data = rand_bytes(K, PART)
    parity = cuda_ec.encode(bigm, data)
    same("encode", parity, torch_ec.apply_gf_bitmatrix(bigm, data), "ec(8,4) 8 MiB parts")
    odd = rand_bytes(K, ODD_N)
    odd_parity = cuda_ec.encode(bigm, odd)
    same("encode", odd_parity, torch_ec.apply_gf_bitmatrix(bigm, odd), f"N={ODD_N}")
    golden = np.stack(rs.encode(K, M, list(odd.cpu().numpy())))
    same("encode", odd_parity.cpu(), torch.from_numpy(golden), "golden rs.encode")

    blocks = rand_bytes((K + M) * CHUNK // K // BS, BS)  # 1536 x 64 KiB
    crcs = cuda_ec.block_crcs(blocks, BS)
    same("block_crcs", crcs, torch_ec.block_crcs(blocks, BS), "1536 x 64 KiB", crc=True)
    golden = crc32.block_crcs_golden(blocks.cpu().numpy())
    same("block_crcs", crcs.cpu(), torch_ec.crc_words_from_numpy(golden), "golden zlib", crc=True)

    p, dcrc, pcrc = cuda_ec.fused_encode_crc(bigm, data, BS)
    wp, wd, wc = torch_ec.fused_encode_crc(bigm, data, BS)
    same("fused_encode_crc", p, wp, "parity of a 64 MiB chunk")
    same("fused_encode_crc", dcrc, wd, "data CRCs", crc=True)
    same("fused_encode_crc", pcrc, wc, "parity CRCs", crc=True)
    gp, gd, gc = CpuChunkEncoder().encode_with_checksums(K, M, data.cpu().numpy(), BS)
    same("fused_encode_crc", p.cpu(), torch.from_numpy(gp), "golden parity")
    same("fused_encode_crc", dcrc.cpu(), torch_ec.crc_words_from_numpy(gd), "golden dcrc", crc=True)
    same("fused_encode_crc", pcrc.cpu(), torch_ec.crc_words_from_numpy(gc), "golden pcrc", crc=True)

    allparts = torch.cat([data, p])
    allcrcs = torch.cat([dcrc, pcrc])
    decode_cases = {}
    for lost in ([3], [1, 5, 8, 10]):
        have = [i for i in range(K + M) if i not in lost]
        used, _ = gf256.recovery_selection(K, M, have, lost)
        rec_m = torch.from_numpy(
            torch_ec.recovery_bitmatrix(K, M, tuple(have), tuple(lost))).to(dev)
        surv = allparts[used].contiguous()
        expected = allcrcs[lost].contiguous()
        rec, rcrc, ok = cuda_ec.fused_decode_verify(rec_m, surv, expected, BS)
        wr, wrc, wok = torch_ec.fused_decode_verify(rec_m, surv, expected, BS)
        same("fused_decode_verify", rec, wr, f"recovered {lost}")
        same("fused_decode_verify", rcrc, wrc, f"CRCs of {lost}", crc=True)
        same("fused_decode_verify", ok, wok, f"ok of {lost}")
        same("fused_decode_verify", rec, allparts[lost], f"golden bytes of {lost}")
        require(bool(ok.all()), f"decode {lost}: every block verifies")
        bad = expected.clone()
        bad[-1, 7] ^= 1
        _, _, ok_bad = cuda_ec.fused_decode_verify(rec_m, surv, bad, BS)
        flipped = (ok_bad != ok).nonzero().tolist()
        require(flipped == [[len(lost) - 1, 7]], f"decode {lost}: one corrupt CRC flips one ok bit")
        decode_cases[len(lost)] = (rec_m, surv, expected)

    # the GF apply's other paths at the main path's widths: a one-part
    # rebuild (an output group of one row) and rows that start off a
    # 16-byte boundary (the byte path)
    rec_m, surv, _ = decode_cases[1]
    one = cuda_ec.encode(rec_m, surv)
    same("encode", one, torch_ec.apply_gf_bitmatrix(rec_m, surv), "one-row recovery, 8 MiB parts")
    same("encode", one, allparts[[3]], "golden bytes of part 3")
    flat = rand_bytes(K * PART + 1)
    unaligned = flat[1:].view(K, PART)
    require(unaligned.data_ptr() % 16 != 0, "an unaligned view")
    same("encode", cuda_ec.encode(bigm, unaligned), torch_ec.apply_gf_bitmatrix(bigm, unaligned),
         "rows off a 16-byte boundary (byte path), 8 MiB parts")

    # other geometries, small: the paths ec(8,4) does not take (output
    # row groups past four, one-row matrices, ragged lengths, small
    # blocks, more than 48 KiB of shared memory at ec(32,32))
    for k, m, n in ((2, 1, 4097), (5, 7, 65536), (32, 32, 65536 + 16), (32, 32, 999)):
        g = torch.from_numpy(torch_ec.encoding_bitmatrix(k, m)).to(dev)
        x = rand_bytes(k, n)
        same("encode", cuda_ec.encode(g, x), torch_ec.apply_gf_bitmatrix(g, x), f"ec({k},{m}) N={n}")
    # block CRCs: small blocks (two spans a block), slab counts that are no
    # multiple of the slabs a step, one block, and more slabs than the
    # resident grid takes in one step
    spans, splits, levels, *_ = cuda_ec._crc_plan(4096, cuda_ec._CRC_VECS * 16,
                                                  cuda_ec._CRC_SPANS, dev)
    crc_grid = cuda_ec._resident(cuda_ec._BLOCK_CRC, cuda_ec._CRC_THREADS, cuda_ec._CRC_STEPS,
                                 cuda_ec._CRC_VECS, levels, dev)
    crc_grid *= cuda_ec._CRC_STEPS * (cuda_ec._CRC_THREADS // spans)  # slabs a grid step
    require(20011 * splits > crc_grid, f"20011 blocks of 4 KiB exceed the {crc_grid} slabs a grid step")
    for bs, count in ((64, 7), (4096, 33), (8192, 5), (BS, 1), (4096, 20011)):
        b = rand_bytes(count, bs)
        same("block_crcs", cuda_ec.block_crcs(b, bs), torch_ec.block_crcs(b, bs),
             f"bs={bs} x {count}", crc=True)
    # the fused kernel's packed tables: ec(5,7) ends on a group of three
    # parity rows, ec(2,1) and every one-part rebuild on a group of one,
    # ec(32,32) carries the largest tables (8 groups of 32 input rows)
    fused_cases = ((3, 2, 4096, 3), (32, 32, BS, 2), (4, 2, 64, 9), (8, 4, 8192, 5),
                   (5, 7, BS, 2), (2, 1, 4096, 3))
    for k, m, bs, nbk in fused_cases:
        g = torch.from_numpy(torch_ec.encoding_bitmatrix(k, m)).to(dev)
        x = rand_bytes(k, nbk * bs)
        got, want = cuda_ec.fused_encode_crc(g, x, bs), torch_ec.fused_encode_crc(g, x, bs)
        for part, (a, b) in enumerate(zip(got, want)):
            same("fused_encode_crc", a, b, f"ec({k},{m}) bs={bs} output {part}", crc=part > 0)
        full = torch.cat([x, got[0]])
        for lost in (list(range(0, k + m, max(1, (k + m) // m)))[:m], [k // 2]):
            have = [i for i in range(k + m) if i not in lost]
            used, _ = gf256.recovery_selection(k, m, have, lost)
            r = torch.from_numpy(
                torch_ec.recovery_bitmatrix(k, m, tuple(have), tuple(lost))).to(dev)
            exp = torch.cat([got[1], got[2]])[lost].contiguous()
            surv = full[used].contiguous()
            rec, rcrc, ok = cuda_ec.fused_decode_verify(r, surv, exp, bs)
            wr, wrc, wok = torch_ec.fused_decode_verify(r, surv, exp, bs)
            what = f"ec({k},{m}) bs={bs} lost {lost}"
            same("fused_decode_verify", rec, wr, f"{what} recovered")
            same("fused_decode_verify", rcrc, wrc, f"{what} CRCs", crc=True)
            same("fused_decode_verify", ok, wok, f"{what} ok")
            same("fused_decode_verify", rec, full[lost], what)
            same("fused_decode_verify", rcrc, exp, f"{what} stored CRCs", crc=True)
            require(bool(ok.all()), f"{what}: every rebuilt block verifies")

    # rows off a 16-byte boundary (views such as buf[1:].view(B, bs)):
    # the CRC wrappers copy them to an aligned buffer
    def offset_view(rows, offset):
        flat = torch.empty(rows.numel() + offset, dtype=torch.uint8, device=dev)
        view = flat[offset:].view(rows.shape)
        view.copy_(rows)
        require(view.data_ptr() % 16 == offset % 16, f"a view {offset} bytes off a boundary")
        return view

    rec_m, surv, expected = decode_cases[4]
    b, x, sv = (offset_view(t, 1) for t in (blocks, data, surv))
    what = "1 byte off a boundary"
    same("block_crcs", cuda_ec.block_crcs(b, BS), torch_ec.block_crcs(blocks, BS), what, crc=True)
    got, want = cuda_ec.fused_encode_crc(bigm, x, BS), torch_ec.fused_encode_crc(bigm, data, BS)
    for part, (u, v) in enumerate(zip(got, want)):
        same("fused_encode_crc", u, v, f"{what} output {part}", crc=part > 0)
    got = cuda_ec.fused_decode_verify(rec_m, sv, expected, BS)
    want = torch_ec.fused_decode_verify(rec_m, surv, expected, BS)
    for part, (u, v) in enumerate(zip(got, want)):
        same("fused_decode_verify", u, v, f"{what} output {part}", crc=part == 1)
    require(bool(got[2].all()), f"decode {what}: every block verifies")
    torch.cuda.synchronize()
    print("kernels match their plain versions and the golden path")

    # -- phase 3: the main path, counted --------------------------------
    rng = np.random.default_rng(SEED)
    chunk = rng.integers(0, 256, CHUNK, dtype=np.uint8)
    st = geometry.ec_type(K, M)
    cuda_ec.reset_launches()
    t0 = time.perf_counter()
    enc = get_encoder("cuda")  # cuda:0, however many cards there are
    parts = striping.split_chunk(chunk, st, enc)
    stripe = np.stack([parts[i] for i in range(K)])
    w_parity, w_dcrc, w_pcrc = enc.encode_with_checksums(K, M, stripe, BS)
    require(all((w_parity[j] == parts[K + j]).all() for j in range(M)), "fused parity = split parity")
    lost1 = 3
    rec1 = enc.recover(K, M, {i: parts[i] for i in range(K + M) if i != lost1}, [lost1])
    require((rec1[lost1] == parts[lost1]).all(), "rebuilt part 3")
    require((enc.checksum(rec1[lost1].reshape(-1, BS)) == w_dcrc[lost1]).all(), "re-checksum of part 3")
    lost4 = [0, 5, 9, 11]
    avail = [i for i in range(K + M) if i not in lost4]
    rec4 = enc.recover(K, M, {i: parts[i] for i in avail}, lost4)
    require(all((rec4[i] == parts[i]).all() for i in lost4), "rebuilt four parts")
    step = flagship.make_reconstruct_step(K, M, avail, lost4, BS)
    stored = np.concatenate([w_dcrc, w_pcrc])[lost4]
    rebuilt, _rcrc, ok = step(np.stack([parts[i] for i in step.used]), stored)
    require(bool(ok.all()), "reconstruct step verifies every block")
    rebuilt = rebuilt.cpu().numpy()
    require(all((rebuilt[j] == parts[i]).all() for j, i in enumerate(lost4)), "reconstruct step bytes")
    fn, (example,) = entry()
    e_parity, e_dcrc, _ = fn(example)
    e_golden = CpuChunkEncoder().encode_with_checksums(K, M, example.cpu().numpy(), 4096)
    require((e_parity.cpu().numpy() == e_golden[0]).all(), "entry() parity")
    require((torch_ec.crc_words_to_numpy(e_dcrc) == e_golden[1]).all(), "entry() CRCs")
    restored = dict(parts)
    restored.update(rec4)
    restored[lost1] = rec1[lost1]
    again = striping.assemble_chunk(restored, st, CHUNK)
    require((again == chunk).all(), "reassembled chunk is byte-identical")
    golden_d = crc32.block_crcs_golden(stripe.reshape(-1, BS)).reshape(K, -1)
    golden_p = crc32.block_crcs_golden(w_parity.reshape(-1, BS)).reshape(M, -1)
    require((w_dcrc == golden_d).all() and (w_pcrc == golden_p).all(), "golden CRCs")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = dict(cuda_ec.LAUNCHES)
    print(f"main path: {main_s:.3f} s, launches {json.dumps(launches)}")
    for name, count in launches.items():
        require(count >= 1, f"{name} launched on the main path")

    # -- phase 4: the multi-device path over every visible card ----------
    wide = multi_device_path(chunk, st)

    # -- phase 5: the chunkserver's rebuild path, on disk ----------------
    rebuild_path(get_encoder("cuda"), card)

    # -- phase 5b: the chunkserver on the wire -----------------------------
    wire_path(get_encoder("cuda"), card)

    # -- phase 5c: a whole cluster: master, chunkservers, client ----------
    cluster_path(card)

    # -- phase 5d: the front doors: FUSE, NFSv3, S3 and the tape tier ------
    frontdoor_path(card)

    # -- phase 5e: failover: the quorum, the promoted shadow, the tools ----
    failover_path(card)

    # -- phase 6: timing -------------------------------------------------
    def window_ms(fn, iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    def time_ms(fn):
        """Median per-call time over WINDOWS windows of >= WINDOW_MS each."""
        fn()
        torch.cuda.synchronize()
        iters = max(1, int(np.ceil(WINDOW_MS / window_ms(fn, 3))))
        return float(np.median([window_ms(fn, iters) for _ in range(WINDOWS)])), iters

    def bound(nbytes, gf_ops, crc_ops):
        # the GF apply at the int8 tensor-core rate (its bit-plane form),
        # the CRC on the CUDA cores; the two units run side by side
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = max(gf_ops / INT8_OPS_PER_S, crc_ops / SCALAR_OPS_PER_S)
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"

    rec_m, surv, expected = decode_cases[1]
    nb = PART // BS
    gf_ops = 2 * 8 * M * 8 * K * PART  # int8 ops of the bit-plane product
    work = {  # name: (kernel call, plain call, bytes, GF int8 ops, CRC scalar ops)
        "encode": (lambda: cuda_ec.encode(bigm, data),
                   lambda: torch_ec.apply_gf_bitmatrix(bigm, data),
                   (K + M) * PART, gf_ops, 0),
        "block_crcs": (lambda: cuda_ec.block_crcs(blocks, BS),
                       lambda: torch_ec.block_crcs(blocks, BS),
                       blocks.numel() + 4 * blocks.shape[0], 0,
                       CRC_OPS_PER_BYTE * blocks.numel()),
        "fused_encode_crc": (lambda: cuda_ec.fused_encode_crc(bigm, data, BS),
                             lambda: torch_ec.fused_encode_crc(bigm, data, BS),
                             (K + M) * PART + 4 * (K + M) * nb, gf_ops,
                             CRC_OPS_PER_BYTE * (K + M) * PART),
        "fused_decode_verify": (lambda: cuda_ec.fused_decode_verify(rec_m, surv, expected, BS),
                                lambda: torch_ec.fused_decode_verify(rec_m, surv, expected, BS),
                                (K + 1) * PART + 9 * nb, gf_ops // M,
                                CRC_OPS_PER_BYTE * PART),
    }
    def host_ms(fn, iters):
        """Host time per call, not waiting for the card: where it comes
        near the kernel time, the card waited for the host."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        ms = (time.perf_counter() - t) * 1e3 / iters
        torch.cuda.synchronize()
        return ms

    def device_ms(fn, calls=20):
        """Device time per call, from torch.profiler: the kernels' own run
        time whatever the host's pace. None where it records none."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
        except RuntimeError as exc:  # no CUPTI: report, time without it
            print(f"torch.profiler: {exc}", file=sys.stderr)
            return None
        total_us = sum(e.self_device_time_total for e in prof.key_averages())
        return total_us / calls / 1e3 if total_us else None

    rows = []
    for name, (kernel, plain, nbytes, g_ops, c_ops) in work.items():
        k_ms, k_iters = time_ms(kernel)
        h_ms = host_ms(kernel, k_iters)
        d_ms = device_ms(kernel)
        p_ms, p_iters = time_ms(plain)
        b_ms, b_by = bound(nbytes, g_ops, c_ops)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "match": err[name] == 0,
        })
        print(json.dumps({
            "kernel": name, "kernel_ms": k_ms, "host_ms": h_ms, "device_ms": d_ms,
            "plain_ms": p_ms,
            "bound_us": b_ms * 1e3, "bound_by": b_by, "launches": launches[name],
            "bytes": nbytes, "gf_int8_ops": g_ops, "crc_scalar_ops": c_ops,
            "kernel_iters": k_iters, "plain_iters": p_iters, "windows": WINDOWS,
            "card": card,
        }))
    # the encoder seam end to end: numpy in, pinned staging, kernels,
    # numpy out
    survivors = {i: parts[i] for i in range(K + M) if i != lost1}
    for path, fn in (
        ("encoder_write_64MiB", lambda: enc.encode_with_checksums(K, M, stripe, BS)),
        ("encoder_rebuild_1_part", lambda: enc.recover(K, M, survivors, [lost1])),
    ):
        print(json.dumps({"path": path, "median_ms": wall_ms(fn), "reps": 5, "card": card}))

    # CRC wrappers on rows off a 16-byte boundary (an aligned copy, then
    # the kernels), beside the aligned call (device time per call; the
    # aligned rows are the kernel lines' inputs)
    b1, x1 = offset_view(blocks, 1), offset_view(data, 1)
    for name, aligned_fn, offset_fn in (
        ("block_crcs", lambda: cuda_ec.block_crcs(blocks, BS), lambda: cuda_ec.block_crcs(b1, BS)),
        ("fused_encode_crc", lambda: cuda_ec.fused_encode_crc(bigm, data, BS),
         lambda: cuda_ec.fused_encode_crc(bigm, x1, BS)),
    ):
        print(json.dumps({
            "offset_case": name, "offset": 1,
            "device_ms": device_ms(offset_fn), "aligned_device_ms": device_ms(aligned_fn),
            "kernel_ms": time_ms(offset_fn)[0], "aligned_kernel_ms": time_ms(aligned_fn)[0],
            "card": card,
        }))

    time_multi_device(wide, card)
    print(card)
    print(json.dumps({"kernels": rows}))
    print_ok()
    return 0


def print_ok() -> None:
    import torch

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


def sync_all() -> None:
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def wall_ms(fn, reps=5) -> float:
    """Median host time of ``reps`` calls that each end with every card
    synchronised."""
    times = []
    for _ in range(reps):
        sync_all()
        t = time.perf_counter()
        fn()
        sync_all()
        times.append((time.perf_counter() - t) * 1e3)
    return sorted(times)[reps // 2]


def multi_device_path(chunk: np.ndarray, st) -> dict:
    """The multi-device path over a mesh of every visible card, with the
    ``encode`` and ``block_crcs`` launch counters set to 0 before it and
    read after it, and the recover counters of a new sharded encoder:
    ``dryrun_multichip`` at its full default shapes, ``ShardedCudaChunkEncoder``
    rebuilding one and then eight parts of that chunk (against the golden
    codec) and a geometry its guard keeps on one card, and the registry's
    one encoder per name (through ``split_chunk`` of ``chunk`` at ``st``).
    Returns what the timing of the wide stripe needs."""
    import torch

    from lizardfs_tpu_torch.core.encoder import (
        CpuChunkEncoder, ShardedCudaChunkEncoder, get_encoder)
    from lizardfs_tpu_torch.entry import dryrun_multichip
    from lizardfs_tpu_torch.ops import cuda_ec, rs
    from lizardfs_tpu_torch.parallel.sharded import make_mesh
    from lizardfs_tpu_torch.utils import striping

    n_cards = torch.cuda.device_count()
    cuda_ec.reset_launches()
    t0 = time.perf_counter()
    ran = dryrun_multichip(n_cards)  # ec(32,8), 64 KiB blocks, 64 MiB logical
    wparts, kill = ran["parts"], ran["kill"]
    require((ran["k"], ran["m"], ran["block_size"], ran["k"] * ran["nb"] * ran["block_size"])
            == (WIDE_K, WIDE_M, BS, CHUNK), "dryrun_multichip at its full default shapes")
    wide = ShardedCudaChunkEncoder(mesh=make_mesh())
    golden_enc = CpuChunkEncoder()
    for lost in ([kill], WIDE_LOST):
        have = {i: wparts[i] for i in range(WIDE_K + WIDE_M) if i not in lost}
        got, want = wide.recover(WIDE_K, WIDE_M, have, lost), golden_enc.recover(WIDE_K, WIDE_M, have, lost)
        require(all((got[i] == want[i]).all() and (got[i] == wparts[i]).all() for i in lost),
                f"sharded encoder rebuilt parts {lost} of the wide stripe")
    require(wide.recovers == {"mesh": 2, "card": 0}, f"both wide rebuilds on the mesh: {wide.recovers}")
    # the geometry the JAX package's guard sends to its mesh and its CRC
    # refuses (ec(4,2), 384-byte parts): the port keeps it on one card
    small = np.random.default_rng(SEED).integers(0, 256, (4, 384), dtype=np.uint8)
    small = np.concatenate([small, np.stack(rs.encode(4, 2, list(small)))])
    got = wide.recover(4, 2, {i: small[i] for i in range(1, 6)}, [0])
    require(wide.recovers["card"] == 1 and (got[0] == small[0]).all(),
            "ec(4,2) 384-byte parts on one card")
    # the registry keeps one encoder per name: a second split_chunk with
    # no encoder reuses the first one's device matrix (no new tables)
    registry = get_encoder()
    striping.split_chunk(chunk, st)
    tables = set(cuda_ec._MATRIX_TABLES)
    striping.split_chunk(chunk, st)
    require(get_encoder() is registry and set(cuda_ec._MATRIX_TABLES) == tables,
            "get_encoder() returns one encoder; split_chunk reuses its matrix")
    sync_all()
    multi = dict(cuda_ec.LAUNCHES)
    print(f"multi-device path: {n_cards} card(s), mesh {ran['mesh'].shape}, "
          f"{time.perf_counter() - t0:.3f} s, launches {json.dumps(multi)}, "
          f"recovers {json.dumps(wide.recovers)}, encoder {registry.name}")
    for name in ("encode", "block_crcs"):
        require(multi[name] >= 1, f"{name} launched on the multi-device path")
    return {"mesh": ran["mesh"], "parts": wparts, "kill": kill, "encoder": wide}


def time_multi_device(wide: dict, card: str) -> None:
    """The ec(32,8) wide stripe over a 64 MiB logical chunk: the mesh step
    and the sharded encoder's one-part rebuild beside one card's encoder,
    numpy in and out (median of 5); ``resident_ms``: the data already on
    ``cuda:0``, the outputs left on the cards."""
    import torch

    from lizardfs_tpu_torch.core.encoder import get_encoder
    from lizardfs_tpu_torch.models import flagship
    from lizardfs_tpu_torch.ops import cuda_ec, torch_ec

    dev = torch.device("cuda", 0)
    wparts, kill = wide["parts"], wide["kill"]
    wdata = np.ascontiguousarray(wparts[:WIDE_K])
    wstep = flagship.make_multichip_step(wide["mesh"], WIDE_K, WIDE_M, BS)
    wdata_dev = torch.from_numpy(wdata).to(dev)
    wbigm = torch.from_numpy(torch_ec.encoding_bitmatrix(WIDE_K, WIDE_M)).to(dev)
    one_card = get_encoder("cuda")
    wsurv = {i: wparts[i] for i in range(WIDE_K + WIDE_M) if i != kill}
    for path, fn, resident, mesh in (
        ("multichip_encode_ec32_8_64MiB", lambda: [a.gather() for a in wstep(wdata)],
         lambda: wstep(wdata_dev), wide["mesh"]),
        ("encoder_write_ec32_8_64MiB", lambda: one_card.encode_with_checksums(WIDE_K, WIDE_M, wdata, BS),
         lambda: cuda_ec.fused_encode_crc(wbigm, wdata_dev, BS), None),
        ("multichip_rebuild_ec32_8_1_part",
         lambda: wide["encoder"].recover(WIDE_K, WIDE_M, wsurv, [kill]), None,
         wide["encoder"].mesh),
        ("encoder_rebuild_ec32_8_1_part", lambda: one_card.recover(WIDE_K, WIDE_M, wsurv, [kill]),
         None, None),
    ):
        print(json.dumps({
            "path": path, "median_ms": wall_ms(fn), "resident_ms": resident and wall_ms(resident),
            "reps": 5, "devices": mesh.size if mesh else 1, "mesh": mesh and mesh.shape,
            "card": card,
        }))


@dataclass
class Addr:
    host: str
    port: int


@dataclass
class PartLoc:
    """A part location as the master hands it out: wire part id, address."""

    part_id: int
    addr: Addr


class StoreExecutor:
    """Runs a read plan wave by wave against chunk stores in this process,
    as the network executor runs it against chunkservers: ``stores`` maps
    an address to its store; a store error or a piece whose CRC does not
    match fails the part. Records the waves that ran and the host time of
    the reads and of the plan's post-processing (recovery)."""

    def __init__(self, stores):
        self.stores = stores
        self.waves: list[int] = []
        self.read_s = self.post_s = 0.0

    def __call__(self, plan, chunk_id, version, locations):
        from lizardfs_tpu_torch.chunkserver.chunk_store import ChunkStoreError
        from lizardfs_tpu_torch.ops import crc32
        from lizardfs_tpu_torch.proto import status

        t0 = time.perf_counter()
        buffer = np.zeros(plan.buffer_size, dtype=np.uint8)
        available: list[int] = []
        unreadable: list[int] = []
        for wave in range(max(op.wave for op in plan.read_operations) + 1):
            self.waves.append(wave)
            for op in (op for op in plan.read_operations if op.wave == wave):
                try:
                    addr, wire_part_id = locations[op.part]
                    pieces = self.stores[addr].read(
                        chunk_id, version, wire_part_id, op.request_offset, op.request_size)
                    if any(crc32.crc32(p) != c for _, p, c in pieces):
                        raise ChunkStoreError(status.CRC_ERROR, f"part {op.part}: piece CRC mismatch")
                except (KeyError, ChunkStoreError):
                    unreadable.append(op.part)
                    require(plan.is_finishing_possible(unreadable), "the plan can still finish")
                    continue
                for off, piece, _crc in pieces:
                    start = op.buffer_offset + off - op.request_offset
                    buffer[start : start + len(piece)] = np.frombuffer(piece, np.uint8)
                available.append(op.part)
            if plan.is_reading_finished(available):
                break
        else:
            raise RuntimeError("check failed: waves exhausted without enough parts")
        t1 = time.perf_counter()
        out = plan.postprocess(buffer, available)
        self.read_s += t1 - t0
        self.post_s += time.perf_counter() - t1
        return out


class Timed:
    """An encoder or store whose named methods add their host time (with
    every card synchronised after each call) to ``seconds``."""

    def __init__(self, inner, *names):
        self._inner, self._names = inner, names
        self.seconds = {name: 0.0 for name in names}

    def __getattr__(self, name):
        fn = getattr(self._inner, name)
        if name not in self._names:
            return fn

        def timed(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            sync_all()
            self.seconds[name] += time.perf_counter() - t
            return out

        return timed


def write_chunk_parts(stores, chunk_id, st, parts, length, crcs=None) -> list[PartLoc]:
    """Write each part's real bytes (``part_length`` of a ``length``-byte
    chunk) block by block into its server's store, with the block CRCs
    ``crcs[p]`` where given (the card's: the store checks each against
    zlib) and a host CRC for a short last piece. Returns the locations."""
    from lizardfs_tpu_torch.core import geometry
    from lizardfs_tpu_torch.ops import crc32
    from lizardfs_tpu_torch.utils import striping

    locs = []
    for p, data in parts.items():
        part_id = geometry.ChunkPartType(st, p).id
        addr = Addr("127.0.0.1", 9400 + p)
        store = stores[(addr.host, addr.port)]
        store.create(chunk_id, 1, part_id)
        real = data[: striping.part_length(st, p, length)]
        for b in range(0, len(real), BS):
            piece = real[b : b + BS]
            crc = int(crcs[p][b // BS]) if crcs is not None and len(piece) == BS else crc32.crc32(piece)
            store.write(chunk_id, 1, part_id, b // BS, 0, piece.tobytes(), crc)
        locs.append(PartLoc(part_id, addr))
    return locs


def rebuild_path(configured, card: str) -> None:
    """The chunkserver's rebuild path on disk, at ec(8,4) over 64 MiB
    chunks of 64 KiB blocks: the parts written through the card's fused
    kernel into one ``ChunkStore`` per server; part 3 lost and rebuilt by
    ``rebuild_part``; the client's degraded read-modify-write read of a
    short chunk, then with a wave-0 source failing; an xor3 part and a
    std copy rebuilt. The ``encode`` and ``block_crcs`` counters are set
    to 0 before the rebuilds and reads and read after them, beside a
    count of the kernel wrappers' calls on rows off a 16-byte boundary
    (the CRC wrappers copy those, the GF apply takes its byte path). Then
    the host-clock split of ``rebuild_part`` (median of 5)."""
    from lizardfs_tpu_torch.chunkserver import replicate
    from lizardfs_tpu_torch.chunkserver.chunk_store import ChunkStore
    from lizardfs_tpu_torch.core import geometry, plans
    from lizardfs_tpu_torch.core.cs_stats import GLOBAL_STATS
    from lizardfs_tpu_torch.ops import cuda_ec
    from lizardfs_tpu_torch.runtime import faults
    from lizardfs_tpu_torch.utils import striping

    st = geometry.load_goal_config(SHIPPED_GOALS)[10].disk_slice().type
    require(int(st) == int(geometry.ec_type(K, M)), f"the shipped goal is ec(8,4): {st!r}")
    encoder = replicate.replicator_encoder(configured)
    rng = np.random.default_rng(SEED + 1)
    chunk = rng.integers(0, 256, CHUNK, dtype=np.uint8)
    short = rng.integers(0, 256, SHORT_CHUNK, dtype=np.uint8)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        stores = {("127.0.0.1", 9400 + p): ChunkStore(f"{root}/cs{p}") for p in range(K + M)}
        # 1. the parts of both chunks, through the fused kernel
        t0 = time.perf_counter()
        located = {}
        for chunk_id, data in ((1, chunk), (2, short)):
            stripe = np.stack(striping.padded_data_parts(data, K)[0])
            parity, dcrc, pcrc = configured.encode_with_checksums(K, M, stripe, BS)
            parts = dict(enumerate(list(stripe) + list(parity)))
            located[chunk_id] = (parts, dcrc, write_chunk_parts(
                stores, chunk_id, st, parts, len(data), np.concatenate([dcrc, pcrc])))
        print(f"rebuild phase: wrote 2 x {K + M} parts in {time.perf_counter() - t0:.3f} s")
        parts, dcrc, locs = located[1]
        lost_id = geometry.ChunkPartType(st, LOST).id
        stores[("127.0.0.1", 9400 + LOST)].delete(1, 1, lost_id)
        sources = [loc for loc in locs if loc.part_id != lost_id]

        cuda_ec.reset_launches()
        with offset_rows_counted() as offset_rows:
            t0 = time.perf_counter()
            # 2. rebuild part 3 into a fresh store
            target = ChunkStore(f"{root}/rebuilt")
            run = StoreExecutor(stores)
            replicate.rebuild_part(target, 1, 1, lost_id, sources, run, encoder)
            check_rebuilt(target, 1, lost_id, parts[LOST], dcrc[LOST])

            # 3. the degraded read (the client's read-modify-write shape) of
            # the short chunk with part 3 missing: in the middle, and over
            # the tail where the trailing parts are short
            sparts, _, slocs = located[2]
            stores[("127.0.0.1", 9400 + LOST)].delete(2, 1, lost_id)
            by_part = {geometry.ChunkPartType.from_id(l.part_id).part:
                       ((l.addr.host, l.addr.port), l.part_id) for l in slocs if l.part_id != lost_id}
            nstripes = -(-SHORT_CHUNK // (K * BS))
            for first, count in (RMW_BLOCKS, (nstripes - RMW_BLOCKS[1], RMW_BLOCKS[1])):
                degraded_read(st, short, first, count, by_part, stores, configured,
                              GLOBAL_STATS, plans, striping)
            # 4. the same read with a wave-0 source failing: a fallback wave
            # (the rule's op pattern names the chunk: its first read fails)
            faults.arm(f"chunkserver:disk_pread:{2:016X}* error,limit=1")
            try:
                waves = degraded_read(st, short, *RMW_BLOCKS, by_part, stores, configured,
                                      GLOBAL_STATS, plans, striping)
                require(faults.fired_total() == 1 and max(waves) >= 1,
                        f"a wave-0 source failed and a fallback wave ran: waves {waves}")
            finally:
                faults.clear()

            # 5. an xor3 part and a std copy, through the same rebuild_part
            for chunk_id, sl, lost in ((3, geometry.xor_type(3), 3),
                                       (4, geometry.SliceType(geometry.STANDARD), 0)):
                xparts = striping.split_chunk(chunk, sl, configured)
                xlocs = write_chunk_parts(stores, chunk_id, sl, xparts, CHUNK)
                xid = geometry.ChunkPartType(sl, lost).id
                if not sl.is_standard:
                    stores[("127.0.0.1", 9400 + lost)].delete(chunk_id, 1, xid)
                    xlocs = [loc for loc in xlocs if loc.part_id != xid]
                replicate.rebuild_part(target, chunk_id, 1, xid, xlocs, StoreExecutor(stores),
                                       encoder)
                check_rebuilt(target, chunk_id, xid, xparts[lost], None)
            sync_all()
        launches = dict(cuda_ec.LAUNCHES)
        print(f"rebuild path: {time.perf_counter() - t0:.3f} s, encoder {encoder.name}, "
              f"launches {json.dumps(launches)}, offset rows {offset_rows[0]}")
        for name in ("encode", "block_crcs"):
            require(launches[name] >= 1, f"{name} launched on the rebuild path")

        # the host-clock split of one part's rebuild, median of 5
        splits = collections.defaultdict(list)
        for _ in range(WINDOWS):
            target.delete(1, 1, lost_id)
            timed_enc = Timed(encoder, "recover", "checksum")
            timed_store = Timed(target, "create", "write")
            run = StoreExecutor(stores)
            t = time.perf_counter()
            replicate.rebuild_part(timed_store, 1, 1, lost_id, sources, run, timed_enc)
            splits["rebuild_part_ms"].append((time.perf_counter() - t) * 1e3)
            splits["plan_read_ms"].append(run.read_s * 1e3)
            splits["recover_ms"].append(timed_enc.seconds["recover"] * 1e3)
            splits["postprocess_ms"].append(run.post_s * 1e3)
            splits["checksum_ms"].append(timed_enc.seconds["checksum"] * 1e3)
            splits["store_write_ms"].append(sum(timed_store.seconds.values()) * 1e3)
        check_rebuilt(target, 1, lost_id, parts[LOST], dcrc[LOST])
    print(json.dumps({"path": "rebuild_part_ec8_4_64MiB_part3", "reps": WINDOWS,
                      **{k: float(np.median(v)) for k, v in splits.items()},
                      "encoder": encoder.name, "card": card}))


def check_rebuilt(store, chunk_id, part_id, want, want_crcs) -> None:
    """The rebuilt part tests clean, holds ``want``'s first
    ``number_of_blocks_in_part`` blocks, and (where given) its CRC slots
    hold ``want_crcs``."""
    from lizardfs_tpu_torch.chunkserver.chunk_store import HEADER_SIZE, SIGNATURE_SIZE
    from lizardfs_tpu_torch.core import geometry

    nblocks = geometry.number_of_blocks_in_part(geometry.ChunkPartType.from_id(part_id))
    cf = store.get(chunk_id, part_id)
    require(cf is not None and store.test_part(cf), f"rebuilt part {part_id} tests clean")
    with open(cf.path, "rb") as f:
        raw = f.read()
    require(raw[HEADER_SIZE:] == want[: nblocks * BS].tobytes(),
            f"rebuilt part {part_id} of chunk {chunk_id}: bytes")
    if want_crcs is not None:
        slots = np.frombuffer(raw[SIGNATURE_SIZE : SIGNATURE_SIZE + 4 * nblocks], ">u4")
        require((slots == want_crcs).all(), f"rebuilt part {part_id}: CRC slots = the write's")


def degraded_read(st, chunk, first, count, by_part, stores, encoder, stats, plans, striping):
    """The client's read-modify-write read of stripes [first, first+count)
    of ``chunk`` (every data part wanted, from the parts in ``by_part``),
    byte for byte against the chunk. Returns the waves that ran."""
    d = st.data_parts
    wanted = list(range(d))
    planner = plans.SliceReadPlanner(
        st, list(by_part), scores={p: stats.score(a) for p, (a, _) in by_part.items()},
        encoder=encoder)
    require(planner.is_readable(wanted), "the degraded read is readable")
    part_sizes = {p: striping.part_length(st, p, len(chunk)) for p in range(st.expected_parts)}
    plan = planner.build_plan(wanted, first, count, part_sizes)
    run = StoreExecutor(stores)
    buf = run(plan, 2, 1, by_part)
    bps = count * BS
    region = striping.assemble_chunk({p: buf[p * bps : (p + 1) * bps] for p in wanted}, st, d * bps)
    want = np.zeros(d * bps, np.uint8)
    piece = chunk[first * d * BS : (first + count) * d * BS]
    want[: len(piece)] = piece
    require(np.array_equal(region, want), f"degraded read of stripes {first}+{count}")
    return run.waves


@contextlib.contextmanager
def offset_rows_counted():
    """Count the kernel wrappers' calls given rows off a 16-byte boundary
    (the CRC wrappers copy those, the GF apply takes its byte path):
    yields a one-element list that holds the count."""
    from lizardfs_tpu_torch.ops import cuda_ec

    count = [0]
    aligned = cuda_ec._aligned

    def counted(t):
        ok = aligned(t)
        count[0] += not ok
        return ok

    cuda_ec._aligned = counted  # read by the CRC wrappers' copy and the GF byte path
    try:
        yield count
    finally:
        cuda_ec._aligned = aligned


def median_ms(times: list[float]) -> float:
    return float(np.median(times)) * 1e3


def sampled(prof, top: int = 6) -> dict:
    """A sampling profiler's samples since its last reset, by thread
    (``loop``: the event loop's; ``worker``: the disk threads of
    ``asyncio.to_thread``; ``other``) and by leaf frame, the ``top``
    most sampled leaves of each."""
    kinds = {}
    for line in prof.collapsed().splitlines():
        stack, _, n = line.rpartition(" ")
        frames = stack.split(";")
        kind = ("loop" if "base_events.run_forever" in frames
                else "worker" if "thread._worker" in frames else "other")
        entry = kinds.setdefault(kind, {"samples": 0, "leaves": collections.Counter()})
        entry["samples"] += int(n)
        entry["leaves"][frames[-1]] += int(n)
    return {k: {"samples": v["samples"], "leaves": dict(v["leaves"].most_common(top))}
            for k, v in kinds.items()}


async def wire_write(cs, chunk_id: int, part_id: int, data: np.ndarray, crcs,
                     chain=()) -> int:
    """Write ``data`` as part ``part_id`` to ``cs`` over the wire, as the
    client's framed path does: a ``CltocsWriteInit`` that creates the part
    (relayed down ``chain``, a list of (server, part id)), one
    ``CltocsWriteData`` a 64 KiB block whose CRC is ``crcs[b]`` (the
    card's; a short last piece carries its host CRC), and a
    ``CltocsWriteEnd``. Every status must be OK. Returns the count of
    pieces that carried a card CRC."""
    import asyncio

    from lizardfs_tpu_torch.ops import crc32
    from lizardfs_tpu_torch.proto import framing
    from lizardfs_tpu_torch.proto import messages as m

    reader, writer = await asyncio.open_connection("127.0.0.1", cs.port)
    try:
        await framing.send_message(writer, m.CltocsWriteInit(
            req_id=1, chunk_id=chunk_id, version=1, part_id=part_id, create=True,
            chain=[m.PartLocation(addr=m.Addr(host="127.0.0.1", port=s.port), part_id=p)
                   for s, p in chain],
        ))
        require((await framing.read_message(reader)).status == 0, f"write init of part {part_id}")
        nblocks = -(-len(data) // BS)
        carried = 0
        for b in range(nblocks):
            piece = data[b * BS : (b + 1) * BS]
            whole = len(piece) == BS
            carried += whole
            await framing.send_message(writer, m.CltocsWriteData(
                req_id=2 + b, chunk_id=chunk_id, write_id=b + 1, block=b, offset=0,
                crc=int(crcs[b]) if whole else crc32.crc32(piece), data=piece.tobytes(),
            ))
        acks = [await framing.read_message(reader) for _ in range(nblocks)]
        require(all(isinstance(a, m.CstoclWriteStatus) and a.status == 0 for a in acks),
                f"every block of part {part_id} acked OK")
        await framing.send_message(writer, m.CltocsWriteEnd(req_id=nblocks + 2, chunk_id=chunk_id))
        require((await framing.read_message(reader)).status == 0, f"write end of part {part_id}")
        return carried
    finally:
        writer.close()


def wire_path(configured, card: str) -> None:
    """The chunkserver on the wire at ec(8,4), port code only: thirteen
    ``ChunkServer``s in this process with ``configured`` (the card's
    encoder), a 64 MiB chunk less 3 blocks and 1000 bytes written over the
    wire with the card's parity and block CRCs, a chain relay, the whole
    read, a degraded read with part 3's server stopped and part 3 rebuilt
    by ``_cmd_replicate`` on the thirteenth server. Every server is stopped
    and the connection pool closed on the way out."""
    import asyncio

    asyncio.run(_wire_path(configured, card))


async def _wire_path(configured, card: str) -> None:
    import asyncio

    from lizardfs_tpu_torch.chunkserver import replicate
    from lizardfs_tpu_torch.chunkserver.server import ChunkServer
    from lizardfs_tpu_torch.core import conn_pool, geometry, plans, read_executor
    from lizardfs_tpu_torch.core.cs_stats import GLOBAL_STATS
    from lizardfs_tpu_torch.ops import cuda_ec
    from lizardfs_tpu_torch.ops import crc32
    from lizardfs_tpu_torch.proto import messages as m
    from lizardfs_tpu_torch.runtime import profiler
    from lizardfs_tpu_torch.utils import striping

    st = geometry.ec_type(K, M)
    rng = np.random.default_rng(SEED + 2)
    chunk = rng.integers(0, 256, SHORT_CHUNK, dtype=np.uint8)
    pid = {p: geometry.ChunkPartType(st, p).id for p in range(K + M)}
    sizes = {p: striping.part_length(st, p, SHORT_CHUNK) for p in range(K + M)}
    times = collections.defaultdict(list)
    servers, stopped = [], set()
    prof = profiler.SamplingProfiler(role="chip_smoke", interval_s=0.005, overhead_budget=0.25)
    # recovery runs on the event loop, as the JAX package's does: the
    # daemons' stall warnings are counted below, not printed
    log = logging.getLogger(ChunkServer.name)
    level = log.level
    log.setLevel(logging.ERROR)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_wire_") as root:
        try:
            for i in range(K + M + 1):
                cs = ChunkServer(f"{root}/cs{i}", master_addr=None, encoder=configured)
                await cs.start()
                servers.append(cs)
            addr = {p: ("127.0.0.1", servers[p].port) for p in range(K + M)}

            # 1. the card's parity and block CRCs, and the twelve parts
            # written over the wire, one server each (the first of three
            # timed writes is the one checked)
            t = time.perf_counter()
            stripe = np.stack(striping.padded_data_parts(chunk, K)[0])
            parity, dcrc, pcrc = configured.encode_with_checksums(K, M, stripe, BS)
            times["encode_ms"].append(time.perf_counter() - t)
            parts = dict(enumerate(list(stripe) + list(parity)))
            crcs = np.concatenate([dcrc, pcrc])
            # a sampling profiler of the daemons' kind (LZ_PROF, on by
            # default), at up to 200 Hz, splits the timed steps by thread
            # and frame
            prof.start()
            for _ in range(3):
                t = time.perf_counter()
                carried = await asyncio.gather(*(
                    wire_write(servers[p], 1, pid[p], parts[p][: sizes[p]], crcs[p])
                    for p in range(K + M)))
                times["write_ms"].append(time.perf_counter() - t)
            profiles = {"write": sampled(prof)}
            print(f"wire phase: wrote {K + M} parts ({sum(sizes.values())} bytes), "
                  f"{sum(carried)} pieces with card CRCs")

            # 2. a std part relayed down a two-server chain: both copies
            # read back identical to the chunk
            std_id = geometry.ChunkPartType(geometry.SliceType(geometry.STANDARD), 0).id
            padded = np.zeros(-(-SHORT_CHUNK // BS) * BS, np.uint8)
            padded[:SHORT_CHUNK] = chunk
            std_crcs = configured.checksum(padded.reshape(-1, BS))
            await wire_write(servers[K + M], 2, std_id, chunk, std_crcs,
                             chain=[(servers[0], std_id)])
            copies = [await read_executor.read_part_range(
                ("127.0.0.1", cs.port), 2, 1, std_id, 0, SHORT_CHUNK) for cs in (servers[K + M], servers[0])]
            require(np.array_equal(copies[0], copies[1]) and np.array_equal(copies[0], chunk),
                    "both copies of the chain-written std part")

            # 3. the whole chunk read back part by part
            for _ in range(3):
                t = time.perf_counter()
                got = await asyncio.gather(*(read_executor.read_part_range(
                    addr[p], 1, 1, pid[p], 0, sizes[p]) for p in range(K)))
                times["read_ms"].append(time.perf_counter() - t)
                require(np.array_equal(striping.assemble_chunk(dict(enumerate(got)), st, SHORT_CHUNK),
                                       chunk), "the whole chunk read over the wire")

            # 4. part 3's server stops; a degraded read of data parts 0-7,
            # blocks 5-41, over the eleven live servers
            await servers[LOST].stop()
            stopped.add(LOST)
            live = {p: (addr[p], pid[p]) for p in range(K + M) if p != LOST}
            first, count = RMW_BLOCKS
            bps = count * BS
            want = chunk[first * K * BS : (first + count) * K * BS]
            cuda_ec.reset_launches()
            with offset_rows_counted() as offset_rows:
                for _ in range(3):
                    planner = plans.SliceReadPlanner(
                        st, list(live), scores={p: GLOBAL_STATS.score(a) for p, (a, _) in live.items()},
                        encoder=configured)
                    plan = planner.build_plan(list(range(K)), first, count, sizes)
                    t = time.perf_counter()
                    buf = await read_executor.execute_plan(plan, 1, 1, live)
                    sync_all()
                    times["degraded_read_ms"].append(time.perf_counter() - t)
                    region = striping.assemble_chunk(
                        {p: buf[p * bps : (p + 1) * bps] for p in range(K)}, st, K * bps)
                    require(np.array_equal(region, want), f"degraded read of stripes {first}+{count}")

                # 5. part 3 rebuilt by _cmd_replicate on the thirteenth server
                target = servers[K + M]
                msg = m.MatocsReplicate(
                    req_id=1, chunk_id=1, version=1, part_id=pid[LOST],
                    sources=[m.PartLocation(addr=m.Addr(host=a[0], port=a[1]), part_id=w)
                             for a, w in live.values()])
                await target._cmd_replicate(msg)
                require(target.metrics.counter("replications").total == 1, "the rebuild ran")
                check_rebuilt(target.store, 1, pid[LOST], parts[LOST], dcrc[LOST])
                sync_all()
            launches = dict(cuda_ec.LAUNCHES)
            recovery = target._replicator_encoder()
            print(f"wire path: encoder {configured.name}, replicator {recovery.name}, "
                  f"launches {json.dumps(launches)}, offset rows {offset_rows[0]}")
            for name in ("encode", "block_crcs"):
                require(launches[name] >= 1, f"{name} launched on the wire path")

            # 6. the rebuild's host-clock split, median of 3
            split = collections.defaultdict(float)
            plan_rebuild, execute_plan = replicate.plan_rebuild, read_executor.execute_plan
            write_rebuilt = replicate.write_rebuilt

            def timed(name, fn):
                def run(*args, **kwargs):
                    t = time.perf_counter()
                    out = fn(*args, **kwargs)
                    sync_all()
                    split[name] += time.perf_counter() - t
                    return out
                return run

            async def timed_execute(*args, **kwargs):
                t = time.perf_counter()
                out = await execute_plan(*args, **kwargs)
                sync_all()
                split["execute_plan"] += time.perf_counter() - t
                return out

            replicate.plan_rebuild = timed("plan_rebuild", plan_rebuild)
            replicate.write_rebuilt = timed("write_rebuilt", write_rebuilt)
            read_executor.execute_plan = timed_execute
            target._recovery_encoder = Timed(recovery, "recover")
            target.encoder = Timed(configured, "checksum")
            prof.reset()
            try:
                for _ in range(3):
                    target.store.delete(1, 1, pid[LOST])
                    split.clear()
                    target._recovery_encoder.seconds["recover"] = 0.0
                    target.encoder.seconds["checksum"] = 0.0
                    t = time.perf_counter()
                    await target._cmd_replicate(msg)
                    times["replicate_ms"].append(time.perf_counter() - t)
                    for name in ("plan_rebuild", "execute_plan", "write_rebuilt"):
                        times[f"{name}_ms"].append(split[name])
                    times["recover_ms"].append(target._recovery_encoder.seconds["recover"])
                    times["checksum_ms"].append(target.encoder.seconds["checksum"])
            finally:
                replicate.plan_rebuild, replicate.write_rebuilt = plan_rebuild, write_rebuilt
                read_executor.execute_plan = execute_plan
                target._recovery_encoder, target.encoder = recovery, configured
            profiles["replicate"] = sampled(prof)
            require(target.metrics.counter("replications").total == 4, "every timed rebuild ran")
            # host zlib over the 64 MiB a rebuild reads, piece by piece,
            # as the source stores and the executor each check it
            pieces = [parts[p][b * BS : (b + 1) * BS].tobytes()
                      for p in range(K) for b in range(PART // BS)]
            for _ in range(3):
                t = time.perf_counter()
                for piece in pieces:
                    crc32.crc32(piece)
                times["host_zlib_64MiB_ms"].append(time.perf_counter() - t)
            check_rebuilt(target.store, 1, pid[LOST], parts[LOST], dcrc[LOST])
            stalls = sum(cs.metrics.counter("loop_stalls").total for cs in servers)
        finally:
            for i, cs in enumerate(servers):
                if i not in stopped:
                    await cs.stop()
            conn_pool.GLOBAL_POOL.close_all()
            prof.stop()
            log.setLevel(level)
    print(json.dumps({"path": "wire_ec8_4_64MiB", "reps": 3, "bytes_written": sum(sizes.values()),
                      "loop_stall_warnings": stalls,
                      **{k: median_ms(v) for k, v in times.items()},
                      "encoder": configured.name, "replicator": recovery.name, "card": card}))
    for step, split in profiles.items():
        print(json.dumps({"profile": f"wire_{step}", **split}))


def kernel_device_ms(prof) -> dict:
    """Device time a ``torch.profiler`` run recorded, in ms: the port's
    kernels (``..._kernel``, in its anonymous namespace), the copies
    between host and card, and each event's own time by name."""
    out = {"kernels_ms": 0.0, "copies_ms": 0.0, "by_name": {}}
    for e in prof.key_averages():
        ms = e.self_device_time_total / 1e3
        if not ms:
            continue
        kernel = re.search(r"\b(\w+_kernel)\b", e.key)
        name = kernel.group(1) if kernel else e.key[:40]
        out["by_name"][name] = out["by_name"].get(name, 0.0) + ms
        if kernel:
            out["kernels_ms"] += ms
        elif e.key.startswith("Memcpy"):
            out["copies_ms"] += ms
    return out


def cluster_path(card: str) -> None:
    """The port as a user runs it, at the shipped ec(8,4) goal: one
    ``MasterServer`` (goal ``SHIPPED_GOALS``), thirteen ``ChunkServer``s
    on the card's encoder and one ``Client`` on ``get_encoder(None)``, in
    this process on localhost ports; a file of ``CLUSTER_BYTES`` written
    through the master's grants, read whole, read degraded with a holder
    of a data part of chunk 0 stopped, and its lost parts rebuilt by the
    master's health loop. Every server is stopped and the connection pool
    closed on the way out."""
    import asyncio

    asyncio.run(_cluster_path(card))


async def _cluster_path(card: str) -> None:
    import asyncio

    import torch
    from torch.profiler import ProfilerActivity, profile

    from lizardfs_tpu_torch.chunkserver import replicate
    from lizardfs_tpu_torch.chunkserver.server import ChunkServer
    from lizardfs_tpu_torch.client.client import Client
    from lizardfs_tpu_torch.core import conn_pool, geometry, read_executor
    from lizardfs_tpu_torch.core.encoder import CpuChunkEncoder, get_encoder
    from lizardfs_tpu_torch.master.server import MasterServer
    from lizardfs_tpu_torch.ops import crc32, cuda_ec
    from lizardfs_tpu_torch.runtime import profiler
    from lizardfs_tpu_torch.utils import striping

    size, reps = CLUSTER_BYTES, CLUSTER_REPS
    goals = geometry.load_goal_config(SHIPPED_GOALS)
    st = goals[10].disk_slice().type
    rng = np.random.default_rng(SEED + 3)
    data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    times = collections.defaultdict(list)
    launches = {}
    servers, stopped, clients = [], set(), []
    master = None
    prof = profiler.SamplingProfiler(role="chip_smoke", interval_s=0.005, overhead_budget=0.25)
    # the rebuilds and degraded reads recover on the event loop, as the
    # JAX package's do: the daemons' stall warnings are counted, not printed
    loggers = [logging.getLogger(name) for name in (ChunkServer.name, MasterServer.name, "client")]
    levels = [lg.level for lg in loggers]
    for lg in loggers:
        lg.setLevel(logging.ERROR)

    def count(step):
        sync_all()
        launches[step] = dict(cuda_ec.LAUNCHES)
        cuda_ec.reset_launches()

    async def heal_wait(chunks, what, timeout=120.0):
        t = time.perf_counter()
        while any(master.meta.registry.evaluate(c).missing_parts for c in chunks):
            require(time.perf_counter() - t < timeout, what)
            await asyncio.sleep(0.01)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cluster_") as root:
        try:
            master = MasterServer(f"{root}/master", goals=goals, health_interval=0.2)
            await master.start()
            for i in range(K + M + 1):
                cs = ChunkServer(f"{root}/cs{i}", master_addr=("127.0.0.1", master.port),
                                 encoder=get_encoder("cuda"))
                await cs.start()
                servers.append(cs)
            client = Client("127.0.0.1", master.port)
            clients.append(client)
            want = "cuda" if torch.cuda.device_count() == 1 else "sharded"
            require(client.encoder.name == want, f"the client's encoder is {want!r}")
            await client.connect()
            f = await client.create(1, "cluster.bin")
            await client.setgoal(f.inode, 10)

            # 1. write: the first of the timed writes is counted and
            # checked; each rewrites the whole file
            cuda_ec.reset_launches()
            prof.start()
            for rep in range(reps):
                t = time.perf_counter()
                await client.write_file(f.inode, data)
                sync_all()
                times["write_ms"].append(time.perf_counter() - t)
                if rep == 0:
                    count("write")
                    phases = {k: v for k, v in client.write_phases.snapshot().items()
                              if k != "reps"}
            profiles = {"write": sampled(prof)}
            node = master.meta.fs.nodes[f.inode]
            nchunks = -(-size // CHUNK)
            require(node.length == size and len(node.chunks) == nchunks,
                    f"the master holds a file of {size} bytes in {nchunks} chunks")
            chunks = [master.meta.registry.chunks[c] for c in node.chunks]
            require(all(len(c.parts) == K + M for c in chunks), "every chunk has its twelve parts")
            # one more write under torch.profiler: the kernels' and the
            # copies' device time beside the write's host time
            with profile(activities=[ProfilerActivity.CUDA]) as tp:
                t = time.perf_counter()
                await client.write_file(f.inode, data)
                sync_all()
                profiled_write_s = time.perf_counter() - t
            write_device = kernel_device_ms(tp)
            cuda_ec.reset_launches()

            # 2. the whole file read back, byte for byte
            for _ in range(reps):
                t = time.perf_counter()
                back = await client.read_file(f.inode)
                times["read_ms"].append(time.perf_counter() - t)
                require(back == data, "the whole file read back")
            count("read")

            # 3. a holder of a data part of chunk 0 stops; the master's
            # rebuilds are held back (its per-chunk retry backoff) until
            # the degraded reads are done
            for c in chunks:
                master._repl_fail_until[c.chunk_id] = time.monotonic() + 3600.0
            victim_id = next(cs for cs, p in sorted(chunks[0].parts) if p < K)
            victim_port = master.meta.registry.servers[victim_id].port
            victim = next(i for i, cs in enumerate(servers) if cs.port == victim_port)
            lost = {c.chunk_id: p for c in chunks for cs, p in c.parts if cs == victim_id}
            t_kill = time.perf_counter()
            await servers[victim].stop()
            stopped.add(victim)
            while master.meta.registry.servers[victim_id].connected:
                require(time.perf_counter() - t_kill < 30.0, "the master sees the server go")
                await asyncio.sleep(0.005)
            detect_s = time.perf_counter() - t_kill
            cuda_ec.reset_launches()
            for _ in range(reps):
                client.cache.invalidate(f.inode)
                t = time.perf_counter()
                back = await client.read_file(f.inode)
                sync_all()
                times["degraded_read_ms"].append(time.perf_counter() - t)
                require(back == data, "the degraded read")
            count("degraded_read")

            # 4. the master's health loop rebuilds the lost parts onto
            # servers that lacked them (chunk 0's spare is the thirteenth)
            split = collections.defaultdict(float)
            plan_rebuild, execute_plan = replicate.plan_rebuild, read_executor.execute_plan
            write_rebuilt = replicate.write_rebuilt

            def timed(name, fn):
                def run(*args, **kwargs):
                    t = time.perf_counter()
                    out = fn(*args, **kwargs)
                    sync_all()
                    split[name] += time.perf_counter() - t
                    return out
                return run

            async def timed_execute(*args, **kwargs):
                t = time.perf_counter()
                out = await execute_plan(*args, **kwargs)
                sync_all()
                split["execute_plan"] += time.perf_counter() - t
                return out

            live = [cs for i, cs in enumerate(servers) if i not in stopped]
            encoders = [(cs._replicator_encoder(), cs.encoder) for cs in live]
            replicate.plan_rebuild = timed("plan_rebuild", plan_rebuild)
            replicate.write_rebuilt = timed("write_rebuilt", write_rebuilt)
            read_executor.execute_plan = timed_execute
            for cs, (recovery, configured) in zip(live, encoders):
                cs._recovery_encoder = Timed(recovery, "recover")
                cs.encoder = Timed(configured, "checksum")
            prof.reset()
            try:
                with profile(activities=[ProfilerActivity.CUDA]) as tp:
                    t_heal = time.perf_counter()
                    master._repl_fail_until.clear()
                    await heal_wait(chunks, "the health loop rebuilds every lost part")
                    sync_all()
                    heal_s = time.perf_counter() - t_heal
            finally:
                replicate.plan_rebuild, replicate.write_rebuilt = plan_rebuild, write_rebuilt
                read_executor.execute_plan = execute_plan
                for cs, (recovery, configured) in zip(live, encoders):
                    split["recover"] += cs._recovery_encoder.seconds["recover"]
                    split["checksum"] += cs.encoder.seconds["checksum"]
                    cs._recovery_encoder, cs.encoder = recovery, configured
            count("rebuild")
            profiles["rebuild"] = sampled(prof)
            heal_device = kernel_device_ms(tp)
            rebuilt = sum(cs.metrics.counter("replications").total for cs in live)
            require(rebuilt >= len(lost), f"{len(lost)} lost parts rebuilt")

            # 5. the rebuilt part of chunk 0 against the numpy golden
            # path: its bytes (a data part: the chunk's own stripes) and
            # its block CRCs
            golden = striping.split_chunk(np.frombuffer(data[:CHUNK], np.uint8), st,
                                          CpuChunkEncoder())
            part0 = lost[chunks[0].chunk_id]
            part_id = geometry.ChunkPartType(st, part0).id
            holder = next(cs for cs in live if cs.store.get(chunks[0].chunk_id, part_id))
            check_rebuilt(holder.store, chunks[0].chunk_id, part_id, golden[part0],
                          crc32.block_crcs_golden(golden[part0].reshape(-1, BS)))
            client.cache.invalidate(f.inode)
            require(await client.read_file(f.inode) == data, "the file read after the rebuild")
            stalls = sum(cs.metrics.counter("loop_stalls").total for cs in servers)
        finally:
            for c in clients:
                await c.close()
            for i, cs in enumerate(servers):
                if i not in stopped:
                    await cs.stop()
            if master is not None:
                await master.stop()
            conn_pool.GLOBAL_POOL.close_all()
            prof.stop()
            for lg, level in zip(loggers, levels):
                lg.setLevel(level)

    for step, floor in (("write", nchunks), ("degraded_read", 1), ("rebuild", 1)):
        require(launches[step]["encode"] >= floor,
                f"encode launched {floor}+ times in the cluster's {step}")
    require(launches["rebuild"]["block_crcs"] >= 1, "block_crcs launched in the cluster's rebuild")
    write_ms = median_ms(times["write_ms"])
    print(f"cluster phase: encoder {want}, launches {json.dumps(launches)}, "
          f"lost parts {sorted(lost.values())} of {len(lost)} chunks")
    print(json.dumps({
        "path": "cluster_ec8_4", "reps": reps, "file_bytes": size, "chunks": nchunks,
        **{k: median_ms(v) for k, v in times.items()},
        "write_ms_each": [t * 1e3 for t in times["write_ms"]],
        "write_MiB_s": size / 2**20 / (write_ms / 1e3),
        "write_phases_ms": phases,
        "detect_ms": detect_s * 1e3, "heal_ms": heal_s * 1e3,
        "kill_to_healed_ms": (detect_s + heal_s) * 1e3,
        "rebuilt_parts": len(lost), "replicate_split_ms": {k: v * 1e3 for k, v in split.items()},
        "profiled_write_ms": profiled_write_s * 1e3, "write_device": write_device,
        "write_kernel_share": write_device["kernels_ms"] / (profiled_write_s * 1e3),
        "heal_device": heal_device,
        "heal_kernel_share": heal_device["kernels_ms"] / (heal_s * 1e3),
        "launches": launches, "loop_stall_warnings": stalls,
        "encoder": want, "card": card,
    }))
    for step, split in profiles.items():
        print(json.dumps({"profile": f"cluster_{step}", **split}))


class FuseOps:
    """A ``LizardFuse`` bridge driven through its ctypes callbacks, with
    no kernel mount. Every call blocks on the bridge's own event loop,
    so make them from a worker thread, never from the loop that serves
    the cluster."""

    def __init__(self, master_port: int):
        from lizardfs_tpu_torch.client import fuse_mount

        self.fm = fuse_mount
        self.bridge = fuse_mount.LizardFuse([("127.0.0.1", master_port)])
        self.ops = None

    def start(self) -> None:
        self.bridge.start()
        self.ops = self.bridge.build_operations()

    def close(self) -> None:
        """The proxy, the client and the pool closed on the bridge's loop,
        then that loop stopped."""
        from lizardfs_tpu_torch.core import conn_pool

        bridge = self.bridge

        async def down():
            if hasattr(bridge, "proxy"):
                await bridge.proxy.stop()
            await bridge.client.close()
            conn_pool.GLOBAL_POOL.close_all()

        try:
            if self.ops is not None:
                bridge._run(down(), timeout=30.0)
        finally:
            bridge.loop.call_soon_threadsafe(bridge.loop.stop)
            bridge._loop_thread.join(30.0)
            bridge.loop.close()

    def handle(self, flags: int = 0):
        import ctypes

        fi = self.fm.FuseFileInfo()
        fi.flags = flags
        return fi, ctypes.pointer(fi)

    def write(self, path: bytes, data: bytes, create: bool) -> int:
        """``create`` (or ``open``), ``write`` in ``FRONTDOOR_PIECE``
        pieces, ``flush``, ``release``; returns the inode."""
        import ctypes
        import os

        fi, ptr = self.handle(os.O_WRONLY)
        rc = self.ops.create(path, 0o644, ptr) if create else self.ops.open(path, ptr)
        require(rc == 0, f"FUSE {'create' if create else 'open'} {path!r}: {rc}")
        for off in range(0, len(data), FRONTDOOR_PIECE):
            piece = data[off:off + FRONTDOOR_PIECE]
            buf = ctypes.create_string_buffer(piece, len(piece))
            rc = self.ops.write(path, ctypes.addressof(buf), len(piece), off, ptr)
            require(rc == len(piece), f"FUSE write at {off}: {rc}")
        require(self.ops.flush(path, ptr) == 0 and self.ops.release(path, ptr) == 0,
                "FUSE flush and release")
        return fi.fh

    def read(self, path: bytes, size: int) -> bytes:
        """``open``, ``read`` in ``FRONTDOOR_PIECE`` pieces, ``release``."""
        import ctypes
        import os

        _, ptr = self.handle(os.O_RDONLY)
        require(self.ops.open(path, ptr) == 0, f"FUSE open {path!r}")
        out = []
        buf = ctypes.create_string_buffer(FRONTDOOR_PIECE)
        for off in range(0, size, FRONTDOOR_PIECE):
            n = min(FRONTDOOR_PIECE, size - off)
            rc = self.ops.read(path, ctypes.addressof(buf), n, off, ptr)
            require(rc == n, f"FUSE read at {off}: {rc}")
            out.append(buf.raw[:n])
        require(self.ops.release(path, ptr) == 0, "FUSE release")
        return b"".join(out)

    def getattr(self, path: bytes):
        import ctypes

        st = self.fm.Stat()
        require(self.ops.getattr(path, ctypes.pointer(st)) == 0, f"FUSE getattr {path!r}")
        return st

    def readdir(self, path: bytes) -> list[bytes]:
        names = []

        def fill(buf, name, st, off):
            names.append(name)
            return 0

        _, ptr = self.handle()
        require(self.ops.readdir(path, None, self.fm.FILL_DIR_T(fill), 0, ptr) == 0,
                f"FUSE readdir {path!r}")
        return names

    def special(self, path: bytes) -> str:
        """A special inode's text (``.masterinfo``, ``.stats``)."""
        import ctypes

        _, ptr = self.handle()
        require(self.ops.open(path, ptr) == 0, f"FUSE open {path!r}")
        buf = ctypes.create_string_buffer(4096)
        n = self.ops.read(path, ctypes.addressof(buf), 4096, 0, ptr)
        self.ops.release(path, ptr)
        require(n > 0, f"FUSE read {path!r}")
        return buf.raw[:n].decode()

    def invalidate(self, inode: int) -> None:
        async def drop():
            self.bridge.client.cache.invalidate(inode)

        self.bridge._run(drop())


def frontdoor_path(card: str) -> None:
    """The ways users reach the file system, at the shipped ec(8,4) goal,
    over one cluster as the cluster phase builds it: a FUSE mount's
    operations (ctypes callbacks, no kernel mount) and its master proxy,
    the NFSv3 gateway, the S3 gateway (a PUT and a three-part multipart
    upload) and the tape server (a demoted object recalled by an S3
    GET); each door's file read whole, then read degraded with holders
    of data parts of every file's chunk 0 stopped, then the master's
    heal. Every gateway, server, proxy and client is stopped and the
    connection pool closed on the way out."""
    import asyncio

    asyncio.run(_frontdoor_path(card))


async def _frontdoor_path(card: str) -> None:
    import asyncio

    import torch
    from torch.profiler import ProfilerActivity, profile

    from lizardfs_tpu_torch.chunkserver.server import ChunkServer
    from lizardfs_tpu_torch.client.client import Client
    from lizardfs_tpu_torch.core import conn_pool, geometry
    from lizardfs_tpu_torch.core.encoder import get_encoder
    from lizardfs_tpu_torch.master.server import MasterServer
    from lizardfs_tpu_torch.nfs.client import Nfs3Client
    from lizardfs_tpu_torch.nfs.server import NfsGateway
    from lizardfs_tpu_torch.ops import cuda_ec
    from lizardfs_tpu_torch.proto import status
    from lizardfs_tpu_torch.s3.client import S3Client
    from lizardfs_tpu_torch.s3.server import S3Gateway
    from lizardfs_tpu_torch.tapeserver.server import TapeServer

    t_phase = time.perf_counter()
    size, reps = FRONTDOOR_BYTES, FRONTDOOR_REPS
    goals = geometry.load_goal_config(SHIPPED_GOALS)
    rng = np.random.default_rng(SEED + 4)
    data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    mpu_sizes = (CHUNK, 2**20, 4242)  # chunk-aligned, so appendchunks shares the first two
    require(sum(mpu_sizes) == size, "the multipart parts make up the file")
    want = "cuda" if torch.cuda.device_count() == 1 else "sharded"
    times = collections.defaultdict(list)
    launches = {}
    devices = {}
    servers, stopped = [], set()
    master = admin = fuse = nfs_gw = nfs = s3_gw = s3 = tape = None
    loggers = [logging.getLogger(name) for name in (
        ChunkServer.name, MasterServer.name, TapeServer.name, "client", "lizardfs.nfs",
        "lizardfs.nfs.rpc", "lizardfs.s3")]
    levels = [lg.level for lg in loggers]
    for lg in loggers:
        lg.setLevel(logging.ERROR)

    def count(step):
        sync_all()
        launches[step] = {k: v for k, v in cuda_ec.LAUNCHES.items() if v}
        cuda_ec.reset_launches()

    async def profiled(door, fn):
        """One more write under ``torch.profiler``: the kernels' and the
        copies' device time beside its host time, and the launches it
        made."""
        sync_all()
        cuda_ec.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
            t = time.perf_counter()
            await fn()
            sync_all()
            ms = (time.perf_counter() - t) * 1e3
        devices[door] = {"profiled_write_ms": ms, "write_device": kernel_device_ms(tp),
                         "profiled_launches": {k: v for k, v in cuda_ec.LAUNCHES.items() if v}}
        cuda_ec.reset_launches()

    async def timed(key, fn, check):
        """One host-clock timing of ``fn``; ``check`` holds its result."""
        t = time.perf_counter()
        out = await fn()
        sync_all()
        times[key].append(time.perf_counter() - t)
        require(check(out), key)
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_frontdoor_") as root:
        try:
            master = MasterServer(f"{root}/master", goals=goals, health_interval=0.2)
            await master.start()
            for i in range(K + M + 1):
                cs = ChunkServer(f"{root}/cs{i}", master_addr=("127.0.0.1", master.port),
                                 encoder=get_encoder("cuda"))
                await cs.start()
                servers.append(cs)
            admin = Client("127.0.0.1", master.port)
            await admin.connect()
            # new files take their directory's goal: the root's for FUSE
            # and NFS, the S3 staging directory's for objects
            await admin.setgoal(1, 10)
            staging = await admin.mkdir(1, ".s3mpu")
            await admin.setgoal(staging.inode, 10)
            inodes = {}

            # 1. FUSE: the bridge's client encodes on the bridge's own loop
            fuse = FuseOps(master.port)
            require(fuse.bridge.client.encoder.name == want, f"the mount's encoder is {want!r}")
            await asyncio.to_thread(fuse.start)
            cuda_ec.reset_launches()
            for rep in range(reps):
                inodes["fuse"] = await timed(
                    "fuse_write_ms", lambda: asyncio.to_thread(fuse.write, b"/fuse.bin", data, rep == 0),
                    bool)
                if rep == 0:
                    count("fuse_write")
            await profiled("fuse", lambda: asyncio.to_thread(fuse.write, b"/fuse.bin", data, False))
            st = await asyncio.to_thread(fuse.getattr, b"/fuse.bin")
            require(st.st_size == size and st.st_ino == inodes["fuse"], "FUSE getattr of the file")
            require(b"fuse.bin" in await asyncio.to_thread(fuse.readdir, b"/"), "FUSE readdir")
            for _ in range(reps):
                await timed("fuse_read_ms",
                            lambda: asyncio.to_thread(fuse.read, b"/fuse.bin", size), data.__eq__)
            count("fuse_read")
            info = await asyncio.to_thread(fuse.special, b"/.masterinfo")
            proxy_port = int(re.search(r"masterproxy: 127\.0\.0\.1:(\d+)", info).group(1))
            tool = Client("127.0.0.1", proxy_port)
            await tool.connect()
            try:
                attr = await tool.lookup(1, "fuse.bin")
                require(attr.inode == inodes["fuse"] and attr.length == size,
                        "a master call through the mount's proxy")
            finally:
                await tool.close()

            # 2. NFSv3: UNSTABLE writes of the server's wtmax, COMMIT, READs
            nfs_gw = NfsGateway("127.0.0.1", master.port)
            require(nfs_gw.client.encoder.name == want, f"the NFS gateway's encoder is {want!r}")
            await nfs_gw.start()
            nfs = Nfs3Client("127.0.0.1", nfs_gw.port)
            await nfs.__aenter__()
            root_fh = await nfs.mnt("/")
            fsinfo = await nfs.fsinfo(root_fh)
            require(fsinfo["wtmax"] == fsinfo["rtmax"] == FRONTDOOR_PIECE, f"NFS FSINFO {fsinfo}")
            code, fh = await nfs.create(root_fh, "nfs.bin")
            require(code == 0, f"NFS CREATE: {code}")
            inodes["nfs"] = int.from_bytes(fh[4:], "big")

            async def nfs_write():
                for off in range(0, size, FRONTDOOR_PIECE):
                    await nfs.write(fh, off, data[off:off + FRONTDOOR_PIECE], stable=0)
                await nfs.commit(fh)

            async def nfs_read():
                out = []
                for off in range(0, size, FRONTDOOR_PIECE):
                    piece, _ = await nfs.read(fh, off, FRONTDOOR_PIECE)
                    out.append(piece)
                return b"".join(out)

            for rep in range(reps):
                await timed("nfs_write_ms", nfs_write, lambda _: True)
                if rep == 0:
                    count("nfs_write")
            await profiled("nfs", nfs_write)
            require((await nfs.getattr(fh))["size"] == size, "NFS GETATTR of the file")
            for _ in range(reps):
                await timed("nfs_read_ms", nfs_read, data.__eq__)
            count("nfs_read")

            # 3. S3: PUT, then a three-part multipart upload of the same bytes
            s3_gw = S3Gateway("127.0.0.1", master.port)
            require(s3_gw.client.encoder.name == want, f"the S3 gateway's encoder is {want!r}")
            await s3_gw.start()
            s3 = S3Client("127.0.0.1", s3_gw.port)
            await s3.create_bucket("doors")
            etag = hashlib.md5(data).hexdigest()
            for rep in range(reps):
                await timed("s3_write_ms", lambda: s3.put_object("doors", "s3.bin", data),
                            lambda r: r.etag == etag)
                if rep == 0:
                    count("s3_write")
            await profiled("s3", lambda: s3.put_object("doors", "s3.bin", data))
            for _ in range(reps):
                await timed("s3_read_ms", lambda: s3.get_object("doors", "s3.bin"),
                            lambda r: r.body == data)
            count("s3_read")

            async def multipart():
                upload = await s3.create_multipart("doors", "mpu.bin")
                etags, off = [], 0
                for n, part in enumerate(mpu_sizes):
                    etags.append(await s3.upload_part("doors", "mpu.bin", upload, n + 1,
                                                      data[off:off + part]))
                    off += part
                return await s3.complete_multipart("doors", "mpu.bin", upload,
                                                   list(enumerate(etags, 1)))

            await timed("s3_multipart_write_ms", multipart, lambda r: r.status == 200)
            count("s3_multipart_write")
            await timed("s3_multipart_read_ms", lambda: s3.get_object("doors", "mpu.bin"),
                        lambda r: r.body == data)
            count("s3_multipart_read")
            inodes["s3"] = (await admin.resolve("/doors/s3.bin")).inode
            inodes["s3_multipart"] = (await admin.resolve("/doors/mpu.bin")).inode

            # 4. the tape tier: demote the S3 object (the master's forced
            # archive first), then a GET recalls it, writing it back
            # through the tape server's client
            tape = TapeServer(f"{root}/tape", ("127.0.0.1", master.port))
            await tape.start()
            require(tape.client.encoder.name == want, f"the tape server's encoder is {want!r}")
            t = time.perf_counter()
            while True:
                try:
                    await admin.tape_demote(inodes["s3"])
                    break
                except status.StatusError as e:
                    require(e.code == status.CHUNK_BUSY and time.perf_counter() - t < 120.0,
                            f"the demote: {e}")
                    await asyncio.sleep(0.05)
            demote_s = time.perf_counter() - t
            require(inodes["s3"] in master.meta.demoted
                    and not master.meta.fs.nodes[inodes["s3"]].chunks,
                    "the demoted object holds no chunk")
            cuda_ec.reset_launches()
            await timed("recall_get_ms", lambda: s3.get_object("doors", "s3.bin"),
                        lambda r: r.body == data and r.etag == etag)
            count("recall")
            require(s3_gw.metrics.counter("s3_recalls").total == 1, "the GET recalled the object")

            # 5. degraded: stop holders of a data part of chunk 0 of every
            # door's file (as few servers as cover them all), the master's
            # rebuilds held back until the reads are done
            chunks = list(master.meta.registry.chunks.values())
            for c in chunks:
                master._repl_fail_until[c.chunk_id] = time.monotonic() + 3600.0
            holders = {door: {cs for cs, p in master.meta.registry.chunks[
                master.meta.fs.nodes[inode].chunks[0]].parts if p < K}
                for door, inode in inodes.items()}
            victims = []
            while any(not (h & set(victims)) for h in holders.values()):
                victims.append(collections.Counter(
                    cs for h in holders.values() if not (h & set(victims)) for cs in h
                ).most_common(1)[0][0])
            require(len(victims) <= M, f"{len(victims)} servers cover every file's chunk 0")
            t = time.perf_counter()
            for cs_id in victims:
                port = master.meta.registry.servers[cs_id].port
                i = next(i for i, cs in enumerate(servers) if cs.port == port)
                await servers[i].stop()
                stopped.add(i)
            while any(master.meta.registry.servers[v].connected for v in victims):
                require(time.perf_counter() - t < 30.0, "the master sees the servers go")
                await asyncio.sleep(0.005)
            cuda_ec.reset_launches()
            for _ in range(reps):
                await asyncio.to_thread(fuse.invalidate, inodes["fuse"])
                await timed("fuse_degraded_read_ms",
                            lambda: asyncio.to_thread(fuse.read, b"/fuse.bin", size), data.__eq__)
            count("fuse_degraded_read")
            for _ in range(reps):
                nfs_gw.client.cache.invalidate(inodes["nfs"])
                await timed("nfs_degraded_read_ms", nfs_read, data.__eq__)
            count("nfs_degraded_read")
            for _ in range(reps):
                s3_gw.client.cache.invalidate(inodes["s3"])
                await timed("s3_degraded_read_ms", lambda: s3.get_object("doors", "s3.bin"),
                            lambda r: r.body == data)
            count("s3_degraded_read")
            s3_gw.client.cache.invalidate(inodes["s3_multipart"])
            await timed("s3_multipart_degraded_read_ms", lambda: s3.get_object("doors", "mpu.bin"),
                        lambda r: r.body == data)
            count("s3_multipart_degraded_read")

            # 6. the master's heal of every lost part
            t = time.perf_counter()
            master._repl_fail_until.clear()
            while any(master.meta.registry.evaluate(c).missing_parts
                      for c in master.meta.registry.chunks.values()):
                require(time.perf_counter() - t < 300.0, "the master heals every lost part")
                await asyncio.sleep(0.01)
            sync_all()
            heal_s = time.perf_counter() - t
            count("heal")
        finally:
            if s3 is not None:
                await s3.close()
            if nfs is not None:
                await nfs.__aexit__(None, None, None)
            for gw in (s3_gw, nfs_gw, tape):
                if gw is not None:
                    await gw.stop()
            if fuse is not None:
                await asyncio.to_thread(fuse.close)
            if admin is not None:
                await admin.close()
            for i, cs in enumerate(servers):
                if i not in stopped:
                    await cs.stop()
            if master is not None:
                await master.stop()
            conn_pool.GLOBAL_POOL.close_all()
            for lg, level in zip(loggers, levels):
                lg.setLevel(level)

    nchunks = -(-size // CHUNK)
    for door in ("fuse", "nfs", "s3", "s3_multipart"):
        require(launches[f"{door}_degraded_read"].get("encode", 0) >= 1,
                f"encode launched in the {door} degraded read")
    for step in ("fuse_write", "nfs_write", "s3_write", "recall"):
        require(launches[step].get("encode", 0) >= nchunks,
                f"encode launched {nchunks}+ times in the {step}")
    require(launches["heal"].get("block_crcs", 0) >= 1, "block_crcs launched in the heal")
    print(f"front doors: encoder {want}, launches {json.dumps(launches)}, "
          f"{len(victims)} servers stopped")
    for door in ("fuse", "nfs", "s3"):
        write_ms = median_ms(times[f"{door}_write_ms"])
        device = devices[door]
        line = {
            "path": f"frontdoor_{door}_ec8_4", "reps": reps, "file_bytes": size,
            "write_ms": write_ms, "write_ms_each": [t * 1e3 for t in times[f"{door}_write_ms"]],
            "write_MiB_s": size / 2**20 / (write_ms / 1e3),
            "read_ms": median_ms(times[f"{door}_read_ms"]),
            "degraded_read_ms": median_ms(times[f"{door}_degraded_read_ms"]),
            **device,
            "write_kernel_share": device["write_device"]["kernels_ms"] / device["profiled_write_ms"],
            "launches": {k: v for k, v in launches.items() if k.startswith(door)},
            "encoder": want, "card": card,
        }
        if door == "s3":
            line.update({k: median_ms(times[k]) for k in (
                "s3_multipart_write_ms", "s3_multipart_read_ms", "s3_multipart_degraded_read_ms")})
        print(json.dumps(line))
    print(json.dumps({
        "path": "frontdoor_tape_recall_ec8_4", "file_bytes": size, "demote_ms": demote_s * 1e3,
        "recall_get_ms": median_ms(times["recall_get_ms"]), "heal_ms": heal_s * 1e3,
        "servers_stopped": len(victims), "launches": {k: launches[k] for k in ("recall", "heal")},
        "phase_s": time.perf_counter() - t_phase, "encoder": want, "card": card,
    }))


def free_udp_port() -> int:
    """A localhost UDP port free now (an election node binds it next)."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def failover_path(card: str) -> None:
    """Metadata redundancy on the card: a port master, its shadow and a
    metalogger in a three-node quorum over thirteen chunkservers at the
    shipped ec(8,4) goal; a file written with the port's ``lizardfs
    put``, the active master stopped, the shadow elected and promoted,
    the file read degraded through it, healed by its health loop, and its
    metadata checksum held against a ``metarestore`` of the metalogger's
    archive. Every daemon, node and client is stopped and the connection
    pool closed on the way out."""
    import asyncio

    asyncio.run(_failover_path(card))


async def _failover_path(card: str) -> None:
    import asyncio
    import io
    import os

    import torch

    from lizardfs_tpu_torch.chunkserver.server import ChunkServer
    from lizardfs_tpu_torch.client.client import Client
    from lizardfs_tpu_torch.core import conn_pool, geometry
    from lizardfs_tpu_torch.core.encoder import CpuChunkEncoder, get_encoder
    from lizardfs_tpu_torch.ha.controller import FailoverController
    from lizardfs_tpu_torch.ha.election import LEADER, ElectionNode
    from lizardfs_tpu_torch.master.changelog import load_image
    from lizardfs_tpu_torch.master.metadata import MetadataStore
    from lizardfs_tpu_torch.master.server import MasterServer
    from lizardfs_tpu_torch.metalogger.server import Metalogger
    from lizardfs_tpu_torch.ops import crc32, cuda_ec
    from lizardfs_tpu_torch.tools import admin_cli, cli, metadump, metarestore
    from lizardfs_tpu_torch.utils import striping

    t_phase = time.perf_counter()
    loop = asyncio.get_running_loop()
    size = FAILOVER_BYTES
    goals = geometry.load_goal_config(SHIPPED_GOALS)
    st = goals[10].disk_slice().type
    data = np.random.default_rng(SEED + 5).integers(0, 256, size, dtype=np.uint8).tobytes()
    nchunks = -(-size // CHUNK)
    want = "cuda" if torch.cuda.device_count() == 1 else "sharded"
    timing = {"election_timeout": FAILOVER_ELECTION_TIMEOUT,
              "heartbeat_interval": FAILOVER_HEARTBEAT}
    times, launches, made = {}, {}, []
    servers, stopped = [], set()
    active = shadow = ml = witness = probe = None
    ctrls = {}
    cli_client = cli.Client

    class Counted(cli_client):
        """The CLI's client, recorded so the phase can read its encoder."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    def count(step):
        sync_all()
        launches[step] = {k: v for k, v in cuda_ec.LAUNCHES.items() if v}
        cuda_ec.reset_launches()

    async def until(cond, what, timeout):
        t = time.perf_counter()
        while not cond():
            require(time.perf_counter() - t < timeout, what)
            await asyncio.sleep(0.005)
        return time.perf_counter() - t

    async def lizardfs(*argv, stdout=None):
        """The port's ``lizardfs`` CLI, ``main`` itself, on a worker
        thread (it runs its own event loop), its client on the card."""
        args = ["--master", ",".join(f"{h}:{p}" for h, p in addrs), *argv]
        with contextlib.redirect_stdout(stdout) if stdout else contextlib.nullcontext():
            rc = await asyncio.to_thread(cli.main, args, None)
        require(rc == 0, f"lizardfs {argv[0]} exits 0")

    # every daemon shares this loop: the stall and election warnings of
    # a busy loop are counted by the daemons, not printed
    logging.disable(logging.WARNING)
    cli.Client = Counted
    with tempfile.TemporaryDirectory(prefix="chip_smoke_failover_") as root:
        try:
            local = os.path.join(root, "failover.bin")
            with open(local, "wb") as fh:
                fh.write(data)
            active = MasterServer(f"{root}/m1", goals=goals, health_interval=0.2)
            await active.start()
            shadow = MasterServer(f"{root}/m2", goals=goals, health_interval=0.2,
                                  personality="shadow", active_addr=("127.0.0.1", active.port))
            await shadow.start()
            # the quorum as the entry points wire it: a controller on each
            # master, a vote-only node on the metalogger
            service = {"a": ("127.0.0.1", active.port), "b": ("127.0.0.1", shadow.port)}
            addrs = list(service.values())
            vote = {nid: ("127.0.0.1", free_udp_port()) for nid in ("a", "b", "ml")}
            ml = Metalogger(f"{root}/ml", list(addrs), image_interval=2.0)

            def peers(nid):
                return {k: v for k, v in vote.items() if k != nid}

            for nid, master in (("a", active), ("b", shadow)):
                ctrls[nid] = FailoverController(master, nid, vote[nid], peers(nid),
                                                service_addrs=service, **timing)
                master.ha_controller = ctrls[nid]

            async def ml_leads():
                raise RuntimeError("a vote-only metalogger won an election")

            async def ml_follows(leader):
                if leader in service:
                    ml.prefer(service[leader])

            witness = ElectionNode("ml", vote["ml"], peers("ml"), get_version=lambda: ml.version,
                                   on_leader=ml_leads, on_follower=ml_follows, can_lead=False,
                                   **timing)
            await ml.start()
            await witness.start()
            await ctrls["a"].start()
            await until(lambda: ctrls["a"].node.state == LEADER, "the active master leads", 60.0)
            await ctrls["b"].start()
            await until(lambda: ctrls["b"].node.leader_id == "a", "the shadow follows", 30.0)
            for i in range(K + M + 1):
                cs = ChunkServer(f"{root}/cs{i}", master_addr=list(addrs),
                                 encoder=get_encoder("cuda"), heartbeat_interval=0.2)
                await cs.start()
                servers.append(cs)
            await until(lambda: len(active.cs_links) == K + M + 1, "the servers register", 30.0)

            # 1. the file written by `lizardfs put`, its client on the card
            cuda_ec.reset_launches()
            t = time.perf_counter()
            await lizardfs("put", local, "/failover.bin", "--goal", "10")
            times["write"] = time.perf_counter() - t
            count("write")
            require([c.encoder.name for c in made] == [want], f"the CLI's encoder is {want!r}")
            node = next(n for n in active.meta.fs.nodes.values() if n.length == size)
            require(len(node.chunks) == nchunks, f"the file holds {nchunks} chunks")
            chunks = [active.meta.registry.chunks[c] for c in node.chunks]
            require(all(len(c.parts) == K + M for c in chunks), "every chunk has its twelve parts")

            # 2. the shadow and the metalogger apply the changelog's tail
            tail = active.changelog.version
            await until(lambda: shadow.changelog.version == tail and ml.version == tail,
                        "the shadow and the metalogger apply the tail", 60.0)
            probe = Client("", 0, master_addrs=list(addrs))
            await probe.connect()
            probe.shadow_reads = False  # its replies come from the active master only
            inode = (await probe.resolve("/failover.bin")).inode
            victim_id = next(cs for cs, p in sorted(chunks[0].parts) if p < K)
            victim_port = active.meta.registry.servers[victim_id].port
            victim = next(i for i, cs in enumerate(servers) if cs.port == victim_port)
            lost = {c.chunk_id: p for c in chunks for cs, p in c.parts if cs == victim_id}
            # the new master's rebuilds held back (its per-chunk retry
            # backoff) until the degraded reads are done
            for c in chunks:
                shadow._repl_fail_until[c.chunk_id] = time.monotonic() + 3600.0

            # 3. the active master and its controller stop; the shadow
            # is elected and promotes itself
            elections = {nid: n.node.elections_started for nid, n in ctrls.items()}
            require(ctrls["a"].promotions == ctrls["b"].promotions == 0,
                    "no promotion before the kill")
            t_kill, kill_at = time.perf_counter(), loop.time()

            async def first_reply():
                while True:
                    try:
                        await probe.getattr(inode)
                        return time.perf_counter() - t_kill
                    except (ConnectionError, OSError, asyncio.TimeoutError):
                        await asyncio.sleep(0.005)

            async def reregistered():
                await until(lambda: len(shadow.cs_links) == K + M + 1,
                            "every server registers with the new master", 60.0)
                return time.perf_counter() - t_kill

            await ctrls["a"].stop()
            await active.stop()
            replied = asyncio.ensure_future(first_reply())
            registered = asyncio.ensure_future(reregistered())
            await until(lambda: shadow.personality == "master", "the shadow is promoted",
                        FAILOVER_PROMOTION_S)
            require(ctrls["b"].promotions == 1 and ctrls["a"].promotions == 0,
                    "exactly one promotion")
            promoted_s = ctrls["b"].last_promotion_at - kill_at
            require(0 < promoted_s < FAILOVER_PROMOTION_S, "the promotion came after the kill")
            reply_s = await asyncio.wait_for(replied, 60.0)
            registered_s = await registered

            # 4. a holder of a data part of chunk 0 stops; the file read
            # degraded through the new master three times: `lizardfs get`,
            # `lizardfs cat`, and a client on both addresses
            await servers[victim].stop()
            stopped.add(victim)
            await until(lambda: not shadow.meta.registry.servers[victim_id].connected,
                        "the new master sees the server go", 30.0)
            degraded = []
            cuda_ec.reset_launches()
            got = os.path.join(root, "got.bin")
            t = time.perf_counter()
            await lizardfs("get", "/failover.bin", got)
            degraded.append(time.perf_counter() - t)
            count("degraded_get")
            with open(got, "rb") as fh:
                require(fh.read() == data, "the degraded `lizardfs get`")
            out = io.TextIOWrapper(io.BytesIO(), write_through=True)
            t = time.perf_counter()
            await lizardfs("cat", "/failover.bin", stdout=out)
            degraded.append(time.perf_counter() - t)
            count("degraded_cat")
            require(out.buffer.getvalue() == data, "the degraded `lizardfs cat`")
            probe.cache.invalidate(inode)
            t = time.perf_counter()
            back = await probe.read_file(inode)
            sync_all()
            degraded.append(time.perf_counter() - t)
            count("degraded_client")
            require(back == data, "the degraded read of a client on both addresses")

            # 5. the new master's health loop heals every lost part (of
            # its own registry's chunks)
            chunks = [shadow.meta.registry.chunks[c.chunk_id] for c in chunks]
            t = time.perf_counter()
            shadow._repl_fail_until.clear()
            await until(lambda: not any(shadow.meta.registry.evaluate(c).missing_parts
                                        for c in chunks),
                        "the new master's health loop heals every lost part", 180.0)
            sync_all()
            times["heal"] = time.perf_counter() - t
            count("heal")
            golden = striping.split_chunk(np.frombuffer(data[:CHUNK], np.uint8), st,
                                          CpuChunkEncoder())
            part0 = lost[chunks[0].chunk_id]
            part_id = geometry.ChunkPartType(st, part0).id
            live = [cs for i, cs in enumerate(servers) if i not in stopped]
            holder = next(cs for cs in live if cs.store.get(chunks[0].chunk_id, part_id))
            check_rebuilt(holder.store, chunks[0].chunk_id, part_id, golden[part0],
                          crc32.block_crcs_golden(golden[part0].reshape(-1, BS)))
            probe.cache.invalidate(inode)
            require(await probe.read_file(inode) == data, "the file read after the heal")
            cuda_ec.reset_launches()

            # 6. the new master's metadata checksum, from lizardfs-admin,
            # against a metarestore of the metalogger's archive
            await until(lambda: ml.version == shadow.changelog.version,
                        "the metalogger follows the new master", 60.0)
            admin_out = io.StringIO()
            with contextlib.redirect_stdout(admin_out):
                rc = await admin_cli._amain([f"127.0.0.1:{shadow.port}", "metadata-checksum"])
            require(rc == 0, "lizardfs-admin metadata-checksum exits 0")
            live_doc = json.loads(admin_out.getvalue())
            _, restored_version = metarestore.restore(f"{root}/ml", f"{root}/restored",
                                                      verbose=False)
            version, doc = load_image(f"{root}/restored")
            restored = MetadataStore()
            restored.load_sections(doc)
            require(restored_version == version == live_doc["version"],
                    "the archive restores to the new master's version")
            require(restored.checksum() == live_doc["checksum"],
                    "the archive restores to the new master's metadata checksum")
            dump = io.StringIO()
            require(metadump.dump(f"{root}/restored", out=dump) == 0, "metadump runs")
            require("failover.bin" in dump.getvalue(), "metadump lists the file")
            elected = {nid: n.node.elections_started - elections[nid] for nid, n in ctrls.items()}
            stalls = sum(cs.metrics.counter("loop_stalls").total for cs in servers)
        finally:
            cli.Client = cli_client
            if probe is not None:
                await probe.close()
            for i, cs in enumerate(servers):
                if i not in stopped:
                    await cs.stop()
            for ctrl in ctrls.values():
                await ctrl.stop()
            if witness is not None:
                await witness.stop()
            if ml is not None:
                await ml.stop()
            for master in (shadow, active):
                if master is not None:
                    await master.stop()
            conn_pool.GLOBAL_POOL.close_all()
            logging.disable(logging.NOTSET)

    require(launches["write"].get("encode", 0) >= nchunks,
            f"encode launched {nchunks}+ times in the write")
    for step in ("degraded_get", "degraded_cat", "degraded_client", "heal"):
        require(launches[step].get("encode", 0) >= 1, f"encode launched in the {step}")
    require(launches["heal"].get("block_crcs", 0) >= 1, "block_crcs launched in the heal")
    print(f"failover: encoder {want}, launches {json.dumps(launches)}, "
          f"lost parts {sorted(lost.values())}, checksum {live_doc['checksum']} "
          f"at version {live_doc['version']}, metadump {dump.getvalue().count(chr(10))} lines")
    print(json.dumps({
        "path": "failover_ec8_4", "file_bytes": size, "chunks": nchunks,
        "write_ms": times["write"] * 1e3, "write_MiB_s": size / 2**20 / times["write"],
        "kill_to_promotion_ms": promoted_s * 1e3, "kill_to_first_reply_ms": reply_s * 1e3,
        "kill_to_reregistered_ms": registered_s * 1e3,
        "degraded_read_ms": median_ms(degraded), "degraded_read_ms_each": [
            t * 1e3 for t in degraded],
        "heal_ms": times["heal"] * 1e3, "rebuilt_parts": len(lost),
        "election_timeout_s": list(FAILOVER_ELECTION_TIMEOUT),
        "heartbeat_s": FAILOVER_HEARTBEAT, "elections_after_kill": elected,
        "promotions": {nid: c.promotions for nid, c in ctrls.items()},
        "demotions": {nid: c.demotions for nid, c in ctrls.items()},
        "launches": launches, "loop_stall_warnings": stalls,
        "phase_s": time.perf_counter() - t_phase, "encoder": want, "card": card,
    }))


if __name__ == "__main__":
    sys.exit(main())
