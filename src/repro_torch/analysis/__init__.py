"""Static analysis for the PyTorch/CUDA port's own bug classes.

``repro_torch.analysis`` is the port's counterpart of ``repro.analysis``:
a stdlib-``ast`` rule engine that parses Python sources WITHOUT importing
them, and reads the kernels' ``.cu`` / ``.cuh`` sources as text.  Its
rules keep the reference's ids where they answer a reference rule, so a
reader finds the counterpart by its number:

======  ==========================  =====================================
id      reference counterpart       the port's rule
======  ==========================  =====================================
RL000   the engine                  a suppression without a justification
                                    (also a syntax error)
RL001   psum under ``jax.grad``     a collective with a backward
                                    (``AllGather.apply``,
                                    ``ReduceScatter.apply``,
                                    ``torch.distributed.nn.functional``)
                                    inside the loss given to a backward
RL002   env read under ``jax.jit``  device / environment / TF32 reads in
                                    a ``torch.compile``d function or a
                                    CUDA-graph capture
RL003   the same (copied)           inline virtual-clock advance outside
                                    ``serving.request.advance_vclock``
RL004   Pallas BlockSpec / VMEM     CUDA launch hygiene in
                                    ``kernels/csrc``: shared-memory
                                    opt-in, checked attributes, launch
                                    errors read, block size within
                                    ``__launch_bounds__``
RL005   the same (copied)           ``docs/observability.md`` catalog
                                    drift, less the rows of the TPU
                                    capacity dispatch
                                    (``NO_COUNTERPART``)
RL006   the same (copied)           ``Transport`` without ``path=``
RL007   none                        a raw kernel wrapper that launches
                                    before ``_refuse_grad`` (an output
                                    with no autograd graph)
RL008   none                        a fallback that hides the device or
                                    the kernel (``cuda.is_available()``
                                    outside ``device.resolve``, a plain
                                    version or the CPU in an ``except``
                                    around a kernel)
======  ==========================  =====================================

Run it as ``python -m repro_torch.analysis`` (default paths:
``src/repro_torch``, ``tests``, ``chip_smoke.py``; it never gates the
reference package ``src/repro``); findings are
``path:line: severity RULE message`` and the exit code is the gate (0
clean, 1 findings, 2 usage error).  Deliberate exceptions are silenced
inline with ``# repro-lint: disable=RLxxx -- justification`` (``//`` in a
CUDA source); the justification is mandatory.
"""
from __future__ import annotations

from repro_torch.analysis.engine import (
    CudaContext,
    Finding,
    LintEngine,
    LintResult,
    ModuleContext,
    Rule,
)
from repro_torch.analysis.rules import RULE_CLASSES, build_rules

__all__ = [
    "CudaContext",
    "Finding",
    "LintEngine",
    "LintResult",
    "ModuleContext",
    "Rule",
    "RULE_CLASSES",
    "build_rules",
    "main",
]


def main(argv=None) -> int:
    """CLI entry point (``python -m repro_torch.analysis``); returns the
    exit code — 0 clean, 1 findings, 2 usage error."""
    from repro_torch.analysis.__main__ import main as _main
    return _main(argv)
