"""Pluggable simulation backends (see ``backends.base`` for the API).

Built-ins:

  ``reference``  the discrete-event heapq loop — the semantics oracle,
                 bit-identical to the pre-backend ``simulate()``.
  ``torch``      the levelized DAG sweep FUSED with the batched duration
                 pass, on the card: an entire population's collective
                 pricing, roofline and schedule evaluate in the ``dse_sim``
                 CUDA kernels (``repro_torch.kernels.dse_sim``).
  ``torch-unfused`` the same sweep kernel fed by the scalar per-call
                 duration pass — the pre-fusion baseline, kept so the
                 duration-pass-vs-sweep split stays measurable.

The torch backends run on the card unless a device is asked for
(``get_backend("torch", device="cpu")`` runs the kernels' plain twins);
without CUDA the default raises.
"""
from __future__ import annotations

from repro_torch.core.backends.base import (BACKEND_REGISTRY, SimBackend,
                                            SimCall, SimJob,
                                            backend_available, get_backend,
                                            list_backends, register_backend,
                                            run_sim_job, run_sim_jobs)


def _reference_factory(device=None) -> SimBackend:
    # host numpy whatever the device: the oracle needs no card
    from repro_torch.core.backends.reference import ReferenceBackend

    return ReferenceBackend()


def _torch_factory(fused: bool = True):
    def factory(device=None) -> SimBackend:
        from repro_torch.core.backends.torch_backend import TorchBackend

        return TorchBackend(fused=fused, device=device)
    return factory


register_backend("reference", _reference_factory,
                 doc="discrete-event heapq loop (bit-exact oracle, default)")
register_backend("torch", _torch_factory(fused=True),
                 doc="fused evaluation on the card — collective + roofline "
                     "pricing and the levelized DAG sweep in the dse_sim "
                     "CUDA kernels")
register_backend("torch-unfused", _torch_factory(fused=False),
                 doc="the dse_sim sweep kernel fed by the scalar per-call "
                     "duration pass (pre-fusion baseline)")

__all__ = [
    "BACKEND_REGISTRY", "SimBackend", "SimCall", "SimJob",
    "backend_available", "get_backend", "list_backends", "register_backend",
    "run_sim_job", "run_sim_jobs",
]
