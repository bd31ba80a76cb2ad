"""PyTorch/CUDA port of the Read-Until flowcell stack (``repro``'s JAX
package stays the reference).

The layout mirrors ``repro`` module for module, so each ported module's
reference sits at the same relative path.  Every Pallas kernel on the
ported path has a hand-written CUDA C++ kernel for Hopper (``sm_90a``)
under ``kernels/csrc/``, built with ``nvcc`` at first use; the plain
PyTorch version of each kernel runs only for tensors that live on the CPU.

Entry point::

    import repro_torch.engine
    eng = repro_torch.engine.build("adaptive_sampling", preset="flowcell_512")
    report = eng.drain()

Entry points run on the card (``device="cuda"``) unless the caller asks
for ``device="cpu"``; with no card and no explicit CPU device they raise.
"""
from repro_torch.device import resolve_device  # noqa: F401
