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
6. times each kernel and its plain version with CUDA events, the CRC
   wrappers on rows off a 16-byte boundary, the encoder's write and
   one-part rebuild end to end (numpy in and out) at ec(8,4), and the
   ec(32,8) wide-stripe encode and rebuild on the mesh beside one card's
   encoder, and prints one JSON line per kernel and per path, the card,
   and a ``{"kernels": [...]}`` line;
7. ends with ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the script exits non-zero.
"""

from __future__ import annotations

import collections
import json
import re
import shutil
import subprocess
import sys
import time

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

    # -- phase 5: timing -------------------------------------------------
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


if __name__ == "__main__":
    sys.exit(main())
