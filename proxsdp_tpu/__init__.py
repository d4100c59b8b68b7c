"""proxsdp_tpu — a JAX conic SDP solver.

Brand-new JAX/XLA implementation with the capabilities of ProxSDP.jl
(primal-dual hybrid gradient with approximate low-rank PSD projection;
arXiv:1810.05231).

The compute path is jit-compiled XLA with static shapes throughout; the
PSD projection uses a batched static-shape Lanczos (ops/lanczos.py); scale
out happens through jax.sharding (parallel/).

Double precision is enabled at import because conic solves at the
reference's default tolerances (1e-4..1e-7) need f64 accumulation; set
``PROXSDP_TPU_NO_X64=1`` before import to opt out (then use
Options(dtype="float32")).
"""

from __future__ import annotations

import os

import jax as _jax

if not os.environ.get("PROXSDP_TPU_NO_X64"):
    _jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache: solver programs are recompiled per
# problem geometry, so repeat runs reuse them from disk.  JAX reads
# JAX_COMPILATION_CACHE_DIR itself; only when it is unset does the package
# point the cache at a fixed directory inside the checkout (a fixed path:
# the path is part of the cache key).  Opt out with
# PROXSDP_TPU_NO_COMPILE_CACHE=1.
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)
if not (
    os.environ.get("PROXSDP_TPU_NO_COMPILE_CACHE")
    or os.environ.get("JAX_COMPILATION_CACHE_DIR")
):
    _jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)

from .options import Options, make_options  # noqa: E402
from .problem import ConeLayout, ConicProblem, preprocess  # noqa: E402
from .result import Result, STATUS_STRINGS, TERMINATION_STATUS  # noqa: E402
from .solver import solve  # noqa: E402
from .api import Optimizer, solve_sdp  # noqa: E402
from .ingest import ConeDims, ConeSolution, solve_cone_program  # noqa: E402
from .utils.vech import ivec, ivech, sympackedlen, vech  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Options",
    "make_options",
    "ConicProblem",
    "ConeLayout",
    "preprocess",
    "Result",
    "STATUS_STRINGS",
    "TERMINATION_STATUS",
    "solve",
    "solve_sdp",
    "Optimizer",
    "ConeDims",
    "ConeSolution",
    "solve_cone_program",
    "ivec",
    "ivech",
    "vech",
    "sympackedlen",
]
