"""``KEY = VALUE`` config files with typed getters and reload.

Functional mirror of the reference's cfg system (reference:
src/common/cfg.h:28-113): plain text config, typed accessors with
defaults and range validation, reloadable in place (SIGHUP handling
lives in the daemon harness).
"""

from __future__ import annotations

import os


class ConfigError(ValueError):
    pass


class Config:
    def __init__(self, path: str | None = None, defaults: dict | None = None):
        self.path = path
        self._values: dict[str, str] = {}
        self._defaults = {k: str(v) for k, v in (defaults or {}).items()}
        if path is not None:
            self.reload()

    @classmethod
    def from_dict(cls, values: dict) -> "Config":
        cfg = cls()
        cfg._values = {k: str(v) for k, v in values.items()}
        return cfg

    def reload(self) -> None:
        if self.path is None:
            return
        values: dict[str, str] = {}
        if os.path.exists(self.path):
            with open(self.path) as f:
                for lineno, raw in enumerate(f, 1):
                    line = raw.split("#", 1)[0].strip()
                    if not line:
                        continue
                    if "=" not in line:
                        raise ConfigError(f"{self.path}:{lineno}: missing '='")
                    key, value = line.split("=", 1)
                    values[key.strip()] = value.strip()
        self._values = values

    def _raw(self, key: str, default=None):
        if key in self._values:
            return self._values[key]
        if key in self._defaults:
            return self._defaults[key]
        return default

    def get_str(self, key: str, default: str | None = None) -> str:
        v = self._raw(key, default)
        if v is None:
            raise ConfigError(f"missing config key {key}")
        return v

    def get_int(
        self,
        key: str,
        default: int | None = None,
        min_value: int | None = None,
        max_value: int | None = None,
    ) -> int:
        v = self._raw(key, None)
        if v is None:
            if default is None:
                raise ConfigError(f"missing config key {key}")
            value = default
        else:
            try:
                value = int(str(v), 0)
            except ValueError:
                raise ConfigError(f"config key {key}={v!r} is not an int") from None
        if min_value is not None and value < min_value:
            raise ConfigError(f"{key}={value} below minimum {min_value}")
        if max_value is not None and value > max_value:
            raise ConfigError(f"{key}={value} above maximum {max_value}")
        return value

    def get_float(
        self,
        key: str,
        default: float | None = None,
        min_value: float | None = None,
    ) -> float:
        v = self._raw(key, None)
        if v is None:
            if default is None:
                raise ConfigError(f"missing config key {key}")
            value = default
        else:
            try:
                value = float(str(v))
            except ValueError:
                raise ConfigError(
                    f"config key {key}={v!r} is not a number"
                ) from None
        # ranged validation like get_int: a zero/negative timer interval
        # busy-loops the daemon instead of failing fast
        if min_value is not None and value < min_value:
            raise ConfigError(f"config key {key}={value} below {min_value}")
        return value

    def get_bool(self, key: str, default: bool | None = None) -> bool:
        v = self._raw(key, None)
        if v is None:
            if default is None:
                raise ConfigError(f"missing config key {key}")
            return default
        s = str(v).strip().lower()
        if s in ("1", "true", "yes", "on"):
            return True
        if s in ("0", "false", "no", "off"):
            return False
        raise ConfigError(f"config key {key}={v!r} is not a bool")

    def as_dict(self) -> dict[str, str]:
        out = dict(self._defaults)
        out.update(self._values)
        return out
