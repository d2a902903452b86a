"""--key=value command-line option parsing.

The port's own copy of ``scrooge_tpu/cli/options.py``. It mirrors the
reference's hand-rolled option parser semantics
(util.cpp:368-427): options are --name or --name=value; querying an option
distinguishes "missing", "exists without value", "exists with value", and
"invalid" (present with a value where none is expected, or vice versa);
unknown options trigger help.
"""

from __future__ import annotations

from enum import Enum
from typing import Dict, List, Optional, Sequence, Tuple


class Opt(Enum):
    MISSING = 0
    EXISTS = 1
    VALUE = 2
    INVALID = 3


def scan_args(argv: Sequence[str]) -> Dict[str, Optional[str]]:
    """argv (without program name) -> {--name: value-or-None}."""
    out: Dict[str, Optional[str]] = {}
    for arg in argv:
        if "=" in arg:
            name, value = arg.split("=", 1)
            out[name] = value
        else:
            out[arg] = None
    return out


def get_flag(args: Dict[str, Optional[str]], name: str) -> Tuple[Opt, None]:
    """Query a value-less flag (util.cpp:387-400 semantics)."""
    if name not in args:
        return Opt.MISSING, None
    if args[name] is not None:
        return Opt.INVALID, None
    return Opt.EXISTS, None


def get_value(args: Dict[str, Optional[str]], name: str,
              default: Optional[str] = None) -> Tuple[Opt, Optional[str]]:
    """Query a --name=value option (util.cpp:402-419 semantics)."""
    if name not in args:
        return Opt.MISSING, default
    if args[name] is None:
        return Opt.INVALID, default
    return Opt.VALUE, args[name]


def check_options(args: Dict[str, Optional[str]],
                  allowed: List[str]) -> bool:
    """True iff every present option is in `allowed` (util.cpp:421-427)."""
    return all(name in allowed for name in args)
