"""HPDDM-style `-hpddm_key value` option parsing.

Counterpart of htool_python_tpu/solvers/options.py, with the same
DEFAULTS and the same parsing.  The registry holds every key the solvers
read (solvers/ddm.py); an unknown key raises ValueError naming it, where
the reference accepted it silently (ROADMAP §3 fault 4).
"""

from __future__ import annotations

DEFAULTS = {
    "krylov_method": "gmres",
    # HPDDM's documented default tolerance
    "tol": 1e-6,
    "max_it": 100,
    "gmres_restart": 40,
    "variant": "right",
    "schwarz_method": "none",
    "schwarz_coarse_correction": "none",
    "compute_residual": None,
    "verbosity": 0,
}

_INT_KEYS = {"max_it", "gmres_restart", "verbosity"}
_FLOAT_KEYS = {"tol"}


def parse_hpddm_args(args: str, into: dict | None = None) -> dict:
    """Parse '-hpddm_key value' pairs (flags without values get True) into
    `into` (default: a copy of DEFAULTS); raises ValueError on a key that
    is not in DEFAULTS."""
    opts = dict(DEFAULTS) if into is None else into
    tokens = args.split()
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        if tok.startswith("-hpddm_"):
            key = tok[len("-hpddm_"):]
            if key not in DEFAULTS:
                raise ValueError(f"unknown option -hpddm_{key} (known: "
                                 f"{', '.join(sorted(DEFAULTS))})")
            if i + 1 < len(tokens) and not tokens[i + 1].startswith("-hpddm_"):
                val = tokens[i + 1]
                i += 2
            else:
                val = True
                i += 1
            if key in _INT_KEYS and val is not True:
                val = int(val)
            elif key in _FLOAT_KEYS and val is not True:
                val = float(val)
            opts[key] = val
        else:
            i += 1
    return opts
