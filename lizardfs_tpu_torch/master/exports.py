"""Client export rules + rack topology.

Exports (mfsexports.cfg analog, reference: src/master/exports.cc):
lines of ``ADDRESS DIRECTORY OPTIONS``:

    *              /        rw,alldirs
    10.0.0.0/8     /data    ro
    10.1.2.3       /        rw,maproot=0,password=secret

Matching is most-specific-prefix-first; a client with no matching rule
is refused at registration. Options: ``ro``/``rw``, ``maproot=UID``
(root squash target), ``password=...``.

Topology (mfstopology.cfg analog, reference: src/master/topology.h):
lines of ``ADDRESS RACKID`` mapping networks to racks; the master sorts
chunk locations so same-rack chunkservers come first for each client.
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass


def _parse_net(s: str) -> ipaddress.IPv4Network:
    if s == "*":
        return ipaddress.ip_network("0.0.0.0/0")
    if "/" not in s:
        s += "/32"
    return ipaddress.ip_network(s, strict=False)


@dataclass
class ExportRule:
    net: ipaddress.IPv4Network
    path: str
    readonly: bool = False
    maproot: int | None = None
    password: str = ""

    @classmethod
    def parse(cls, line: str) -> "ExportRule | None":
        line = line.split("#", 1)[0].strip()
        if not line:
            return None
        parts = line.split()
        if len(parts) < 2:
            raise ValueError(f"malformed export line: {line!r}")
        net = _parse_net(parts[0])
        path = parts[1]
        rule = cls(net=net, path=path)
        for opt in (parts[2].split(",") if len(parts) > 2 else []):
            opt = opt.strip()
            if opt == "ro":
                rule.readonly = True
            elif opt in ("rw", "alldirs", ""):
                pass
            elif opt.startswith("maproot="):
                rule.maproot = int(opt.split("=", 1)[1])
            elif opt.startswith("password="):
                rule.password = opt.split("=", 1)[1]
            else:
                raise ValueError(f"unknown export option {opt!r}")
        return rule


class Exports:
    def __init__(self, rules: list[ExportRule] | None = None):
        # default: everyone, rw, whole tree (open cluster)
        self.rules = rules if rules is not None else [
            ExportRule(net=_parse_net("*"), path="/")
        ]

    @classmethod
    def load(cls, text: str) -> "Exports":
        rules = []
        for lineno, line in enumerate(text.splitlines(), 1):
            try:
                rule = ExportRule.parse(line)
            except ValueError as e:
                raise ValueError(f"exports line {lineno}: {e}") from None
            if rule:
                rules.append(rule)
        return cls(rules)

    def match(self, ip: str, password: str = "") -> ExportRule | None:
        """Most-specific matching rule whose password matches."""
        try:
            addr = ipaddress.ip_address(ip)
        except ValueError:
            addr = ipaddress.ip_address("127.0.0.1")
        best: ExportRule | None = None
        for rule in self.rules:
            if addr in rule.net:
                if rule.password and rule.password != password:
                    continue
                if best is None or rule.net.prefixlen > best.net.prefixlen:
                    best = rule
        return best


class Topology:
    """IP network -> rack id; distance 0 = same rack, 1 = different."""

    def __init__(self):
        self.nets: list[tuple[ipaddress.IPv4Network, int]] = []

    @classmethod
    def load(cls, text: str) -> "Topology":
        topo = cls()
        for lineno, line in enumerate(text.splitlines(), 1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) != 2:
                raise ValueError(f"topology line {lineno}: {line!r}")
            topo.nets.append((_parse_net(parts[0]), int(parts[1])))
        return topo

    def rack_of(self, ip: str) -> int:
        try:
            addr = ipaddress.ip_address(ip)
        except ValueError:
            return -1
        best_len = -1
        rack = -1
        for net, rid in self.nets:
            if addr in net and net.prefixlen > best_len:
                best_len = net.prefixlen
                rack = rid
        return rack

    def distance(self, ip_a: str, ip_b: str) -> int:
        if ip_a == ip_b:
            return 0
        ra, rb = self.rack_of(ip_a), self.rack_of(ip_b)
        if ra >= 0 and ra == rb:
            return 1
        return 2
