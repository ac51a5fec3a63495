"""Runtime-tunable knobs — the `.lizardfs_tweaks` registry, daemon-side.

The reference exposes a registry of named atomics through a magic file
on the mount (reference: src/mount/tweaks.h:29-47). Here every daemon
holds a Tweaks registry readable/settable over the admin protocol
(`lizardfs-admin tweaks` / `tweaks-set`).
"""

from __future__ import annotations


class Tweak:
    def __init__(self, name: str, value, caster, on_set=None):
        self.name = name
        self.value = value
        self._cast = caster
        # side-effect hook: tweaks that alias another subsystem (e.g.
        # debug_read_delay_ms arming a fault-injection rule) react to
        # live admin sets without the daemon polling the value
        self._on_set = on_set

    def set(self, raw: str) -> None:
        self.value = self._cast(raw)
        if self._on_set is not None:
            self._on_set(self.value)


class Tweaks:
    def __init__(self):
        self._tweaks: dict[str, Tweak] = {}

    def register(self, name: str, initial, on_set=None):
        caster = type(initial)
        if caster is bool:
            caster = lambda s: str(s).lower() in ("1", "true", "yes", "on")  # noqa: E731
        t = Tweak(name, initial, caster, on_set=on_set)
        self._tweaks[name] = t
        return t

    def get(self, name: str) -> Tweak | None:
        return self._tweaks.get(name)

    def set(self, name: str, raw: str) -> bool:
        t = self._tweaks.get(name)
        if t is None:
            return False
        t.set(raw)
        return True

    def to_dict(self) -> dict:
        return {name: t.value for name, t in sorted(self._tweaks.items())}
