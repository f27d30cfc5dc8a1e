"""parelagmc_tpu_torch - the PyTorch + CUDA (Hopper) port of parelagmc_tpu.

The JAX package `parelagmc_tpu/` is the reference; this package mirrors its
module layout (config.py, mesh/, fem/, ops/, samplers/, physics/, uq/,
parallel/, utils/, problems.py, unstructured.py) so that every counterpart
is found under the same path. It imports torch and nothing of jax or of the JAX package: the
host-side setup (config, mesh, FEM assembly, hierarchies, Galerkin blocks)
is the port's own numpy copy of what it calls from the reference, and the
few host build functions that live in jax-importing modules there are
re-written in numpy. Its entry points run on cuda:0 unless the caller
passes another `device` (the CPU tests pass device="cpu").

Device compute is plain PyTorch except for the kernels that the reference
wrote in Pallas for the TPU; those are hand-written CUDA C++ for sm_90a
(`csrc/`, built at first use by `kernels/`), each with its plain PyTorch
version beside it:

* K1 `ops/tridiag_pallas.thomas_lines` - batched Thomas tridiagonal line
  solves on strided lines (the velocity mass inverse M(w)^{-1} of the
  Darcy Schur CG on its flat face layout, and the coefMG line smoother);
* K2 `ops/prng.sample_normals` - counter-based threefry2x32 normals that
  reproduce jax.random's CPU stream bit for bit.

Slices covered so far: the golden MLMC path (box mesh, SPDE sampler,
cg-schur Darcy solver, MLMC manager), the SPE10-scale structured path
(cg-schur-coefmg, kinv_ref, adjoint QoI), K3 (uniform noise), the other
structured samplers and Darcy solvers, the Bayesian ratio managers, sample
sharding (parallel/sharding.py), MLMC on simplicial meshes, nested or
agglomerated (unstructured.py), the hybridized `hybrid-cg` solver
(physics/hybrid.py), mesh files with embedded and projection samplers
(native/, transfer_integrators.py), the command-line drivers and the
evidence and tuning drivers (examples/), spatial sharding
(parallel/spatial_darcy.py, parallel/spatial.py), and the root entry
points' twins: the golden pair-step bench (bench.py) and the forward step
with the multi-device dry run (graft_entry.py). See ROADMAP.md for what is
left.
"""

__version__ = "0.1.0"

from parelagmc_tpu_torch.config import ProblemConfig  # noqa: F401
