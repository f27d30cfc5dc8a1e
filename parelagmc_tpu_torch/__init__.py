"""parelagmc_tpu_torch - the PyTorch + CUDA (Hopper) port of parelagmc_tpu.

The JAX package `parelagmc_tpu/` is the reference; this package mirrors its
module layout (ops/, samplers/, physics/, uq/, utils/, problems.py) so that
every counterpart is found under the same path. It imports torch and never
jax: the host-side setup (mesh, FEM assembly, hierarchies, config) is
imported from the jax-free modules of the reference package, and the few
host build functions that live in jax-importing modules are re-written in
numpy.

Device compute is plain PyTorch except for the kernels that the reference
wrote in Pallas for the TPU; those are hand-written CUDA C++ for sm_90a
(`csrc/`, built at first use by `kernels/`), each with its plain PyTorch
version beside it:

* K1 `ops/tridiag_pallas.thomas` - batched Thomas tridiagonal line solves
  (the velocity mass inverse M(w)^{-1} of the Darcy Schur CG);
* K2 `ops/prng.sample_normals` - counter-based threefry2x32 normals that
  reproduce jax.random's CPU stream bit for bit.

Slice covered so far: the golden MLMC path (box mesh, SPDE sampler,
cg-schur Darcy solver, MLMC manager). See ROADMAP.md for what is left.
"""

__version__ = "0.1.0"

from parelagmc_tpu.config import ProblemConfig  # noqa: F401
