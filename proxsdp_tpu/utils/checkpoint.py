"""Solver-state checkpoint/resume.

The reference has NO checkpointing (SURVEY.md §5: a dead ``WarmStart``
struct, structs.jl:94-98, and a roadmap note README.md:145-148).  Here the
entire PDHG state is a flat pytree of arrays, so a checkpoint is one
``np.savez`` — this closes that gap and makes multi-hour solves (and
preemptible runs) restartable.

Write is atomic (tmp file + rename): a preemption mid-save never corrupts
the previous checkpoint.

Version history:
  1 — original format (packed-triangle ``state.x`` layout implied)
  2 — adds ``__square_form__`` (device-coordinate convention of
      ``state.x``); resume validates it against the rebuilt layout so a
      layout mismatch fails with a clear message instead of an opaque
      jit/shape error.
"""

from __future__ import annotations

import os

import numpy as np

CKPT_VERSION = 2


def save_checkpoint(
    path: str, state, phase32: bool, square_form: bool | None = None
) -> None:
    """Serialize a solver ``State`` (+ hybrid-phase flag) to ``path``."""
    arrs = {}
    for name in type(state)._fields:
        v = getattr(state, name)
        if name == "warm":
            arrs["__warm_len__"] = np.asarray(len(v))
            for i, w in enumerate(v):
                arrs[f"__warm_{i}__"] = np.asarray(w)
        else:
            arrs[name] = np.asarray(v)
    arrs["__phase32__"] = np.asarray(bool(phase32))
    arrs["__version__"] = np.asarray(CKPT_VERSION)
    if square_form is not None:
        arrs["__square_form__"] = np.asarray(bool(square_form))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    os.replace(tmp, path)


def load_checkpoint(path: str, expect_square_form: bool | None = None):
    """Return ``(state, phase32)`` saved by :func:`save_checkpoint`.

    ``expect_square_form``: the coordinate convention of the layout the
    caller rebuilt (Options.square_form); mismatching checkpoints raise a
    ValueError naming the fix instead of failing later with a shape error.
    """
    from ..solver import State

    with np.load(path) as z:
        version = int(z["__version__"])
        if version not in (1, 2):
            raise ValueError(
                f"checkpoint version {version} > supported {CKPT_VERSION}"
            )
        if expect_square_form is not None:
            if "__square_form__" in z:
                saved_sq = bool(z["__square_form__"])
            else:
                # v1 checkpoints predate the square-form device layout
                saved_sq = False
            if saved_sq != bool(expect_square_form):
                raise ValueError(
                    f"checkpoint {path!r} was written with "
                    f"square_form={saved_sq} but this solve uses "
                    f"square_form={bool(expect_square_form)}; re-solve "
                    "with Options(square_form="
                    f"{saved_sq}) to resume it, or discard the checkpoint"
                )
        warm = tuple(
            z[f"__warm_{i}__"] for i in range(int(z["__warm_len__"]))
        )
        fields = {
            name: z[name] for name in State._fields if name != "warm"
        }
        phase32 = bool(z["__phase32__"])
    return State(warm=warm, **fields), phase32
