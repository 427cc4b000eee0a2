"""Shared provenance stamping for the port's benchmark drivers.

The reference's benchmark contract is one self-describing CSV line per run
(README.md:19-21, final/SpGEMM_mpi_omp.c:336).  Every driver row passes
through :func:`emit`, which stamps it with the time and the card (its name and
power limit as ``nvidia-smi`` prints them: a card below its 700 W maximum runs
slower under load) and refuses a timed row that does not say whether its
output was checked.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RESULTS = os.path.join(HERE, "results.jsonl")
MICRO = os.path.join(HERE, "micro.jsonl")


@functools.lru_cache(maxsize=1)
def card() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` for
    the first card, or None where ``nvidia-smi`` cannot run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def require_card():
    """The ``torch.device`` a driver measures on; raises where there is no
    CUDA card (a driver's numbers are the card's, never the CPU's)."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("this driver measures a CUDA card and found none")
    return torch.device("cuda")


def stamp(rec: dict, **extra) -> dict:
    """Add ISO timestamp, the card (+ any extra fields) to a result row, in place."""
    rec.update(extra)
    rec.setdefault("ts", time.strftime("%Y-%m-%dT%H:%M:%S"))
    rec.setdefault("card", card())
    return rec


def is_timed(rec: dict) -> bool:
    """A row that reports an engine/kernel duration (any ``*_s`` field, the
    short A/B keys ``t``/``seconds``, or a rate field)."""
    return any(
        k == "t" or k == "seconds" or k.endswith("_s") or k.endswith("ns_per_elem")
        for k in rec
    )


def emit(rec: dict, path: str | None = None) -> dict:
    """Stamp, print, and append one row to ``path`` (default
    ``results.jsonl`` beside this file).

    Provenance contract: a row that TIMES anything must carry ``bit_exact`` —
    True/False when the driver compared outputs that run, or the literal
    string ``"n/a"`` for pure rate rows where bit-exactness is meaningless.
    ``None``/missing is refused: an untagged timed row can't be trusted
    run-over-run.
    """
    stamp(rec)
    if "error" not in rec and is_timed(rec):
        be = rec.get("bit_exact")
        if be is None or not (isinstance(be, bool) or be == "n/a"):
            raise ValueError(
                "provenance: timed row requires bit_exact True/False/'n/a' "
                f"(got {be!r}): {json.dumps(rec)[:200]}"
            )
    line = json.dumps(rec)
    print(line, flush=True)
    with open(path or RESULTS, "a") as f:
        f.write(line + "\n")
    return rec


def sort_fraction(ex, seconds: float) -> float:
    """Roofline fraction for one EllSpGEMMExecutor run (sort model), on the
    card that holds the executor's staged arrays."""
    from ..utils.trace import roofline

    r = roofline(
        ex.total_slots, 0, 0, seconds, ex.er_all.device, sort_len=ex.sort_pad
    )
    return round(r["fraction_of_roofline"], 4)
