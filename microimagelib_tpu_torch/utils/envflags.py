"""Boolean MIL_* environment-flag parsing.

One convention for every on/off flag in the library: the values
"0", "false", "off", "no" and "" (case-insensitive) mean OFF, anything
else means ON. This keeps `MIL_X=off` from silently enabling a stage
(the historical `!= "0"` checks treated any non-"0" string as on).
"""

import os

_OFF = {"0", "false", "off", "no", ""}

__all__ = ["env_on"]


def env_on(name, default=False):
    """True iff env var ``name`` is set to a truthy value (or unset and
    ``default`` is True)."""
    val = os.environ.get(name)
    if val is None:
        return bool(default)
    return val.strip().lower() not in _OFF
