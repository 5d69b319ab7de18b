"""montecarlooptionspricer_tpu_torch — the PyTorch/CUDA port of the
fit-then-stream American-option pricer in ``montecarlooptionspricer_tpu``.

The JAX package is the reference; this package imports ``torch`` and never
``jax`` (nor anything of the JAX package).  Module names follow the JAX
package so each function's counterpart is easy to find.

Layer map:
  ops/      payoff, integer-exact time grid, polynomial regression.
  models/   LSM backward induction (``lsm``), the fused path kernels and
            their plain versions (``pathgen_cuda``), and the streaming
            engine (``engine``).
  kernels/  builds ``csrc/*.cu`` with ``nvcc`` at first use (sm_90a).
  parallel/ the multi-device forms: one process per device in a
            ``torch.distributed`` group (``make_mesh``, the sharded
            runners); the pricers, the pipeline and the trainer take
            ``mesh=``.
  utils/    logging, ``torch.profiler`` traces and spans, the kernel
            build cache.
  cli/      ``mcop-price-torch``, ``mcop-prediction-gen-torch``,
            ``mcop-train-nn-torch``, ``mcop-evaluate-nn-torch``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU each kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
