"""Device-mesh sharding for the two scale axes of the problem.

The reference scales with shared-memory threads (TBB over variants inside
one GRM product) and independent per-host jobs merged at the file level
(SURVEY.md §2.3).  This package instead shards:

* **samples** for the null fit: the standardized genotype matrix
  ``G_std [M, N]`` is sharded over its sample axis, so every PCG step's
  ``G'(G v)`` computes local partials and XLA inserts the ``psum`` over
  the interconnect for the M-vector inner products (the moral equivalent of the
  reference's per-thread accumulator + reduce, src/saige_fitnull.cpp:521-535);
* **variants** for the scan: dosage blocks are sharded over their batch
  axis with the null-model state replicated — embarrassingly parallel,
  partial result tables merged on the host.

Everything uses ``jax.sharding.NamedSharding`` + jit; no hand-written
collectives are needed because the contraction structure makes XLA's
choices optimal (one all-reduce per GRM product).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices but only {len(devs)} available")
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def pad_dim(x, axis: int, multiple: int, value: float = 0.0):
    """Zero-pad ``x`` along ``axis`` up to the next multiple of ``multiple``.

    NamedSharding requires the sharded dimension to divide evenly across the
    mesh; real sample counts / trailing variant blocks rarely do.  Padding
    with zeros is exact for every kernel here: zero genotype columns
    contribute nothing to ``G'(Gv)`` partials, and padded variant rows are
    masked out of the result tables by the caller slicing to the original
    length.
    """
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(jnp.asarray(x), widths, constant_values=value)


def shard_grm(grm, mesh: Mesh, axis: str = "data"):
    """Shard a GRMOperator sample-wise across the mesh."""
    from ..ops.grm import GRMOperator

    if grm.n_samples % mesh.devices.size != 0:
        raise ValueError(
            f"n_samples={grm.n_samples} must divide the {mesh.devices.size}-"
            f"device mesh; pad samples (pad_dim with zero genotype columns, "
            f"W=1, rhs=0) before sharding the fit")

    samp = NamedSharding(mesh, P(None, axis))   # [M, N] split on N
    vec = NamedSharding(mesh, P(axis))          # [N]
    return GRMOperator(
        std_geno=jax.device_put(grm.std_geno, samp),
        diag=jax.device_put(grm.diag, vec),
        n_variants=grm.n_variants,
        n_samples=grm.n_samples,
    )


def shard_vectors(mesh: Mesh, x, axis: str = "data"):
    """Place [N] / [N, R] arrays with their sample axis sharded."""
    spec = P(axis) if np.ndim(x) == 1 else P(axis, None)
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


def shard_variant_batch(mesh: Mesh, G, axis: str = "data"):
    """Shard a dosage block [B, N] over variants (batch axis).

    Blocks whose length does not divide the mesh are zero-padded (a
    zero-dosage variant is filtered out by the MAC filter downstream); the
    caller slices result tables back to the original ``B``.
    """
    G = pad_dim(jnp.asarray(G), 0, mesh.devices.size)
    return jax.device_put(G, NamedSharding(mesh, P(axis, None)))


class ShardedGrmHandle:
    """Drop-in GRM handle that pads the sample axis to the mesh size and
    shards the operator + every per-call vector across the devices.

    The fitter's host loop (``models/fitnull.py``) is oblivious: it calls
    ``handle.pcg(...)`` / ``handle.mv(...)`` with original-size numpy
    arrays and gets original-size results back; internally each solve runs
    as one sharded XLA program with a ``psum`` per GRM product over the
    mesh axis (the device equivalent of the reference's per-thread-buffer
    reduce, src/saige_fitnull.cpp:521-535).

    Padding is exact: padded samples carry zero genotype columns, weight 1
    and rhs 0, so they stay identically zero through PCG (for the packed
    operator the rank-1 centering term is masked via ``samp_mask``).
    """

    is_grm_handle = True    # duck-typed marker (fitnull._pcg/_grm_mv)

    def __init__(self, op, mesh: Mesh, axis: str = "data"):
        from ..ops.grm import GRMOperator
        from ..ops.packed_grm import PackedGRM

        nd = mesh.devices.size
        N = op.n_samples
        Np = -(-N // nd) * nd
        pad = Np - N
        self.mesh, self.axis = mesh, axis
        self.n_orig, self.n_padded = N, Np
        self._mat = NamedSharding(mesh, P(None, axis))
        self._vec = NamedSharding(mesh, P(axis))
        self._cols = NamedSharding(mesh, P(axis, None))
        repl = NamedSharding(mesh, P())

        def put(x, sh):
            return jax.device_put(jnp.asarray(x), sh)

        if isinstance(op, GRMOperator):
            self.op = GRMOperator(
                std_geno=put(jnp.pad(op.std_geno, ((0, 0), (0, pad))),
                             self._mat),
                diag=put(jnp.pad(op.diag, (0, pad)), self._vec),
                n_variants=op.n_variants, n_samples=Np)
        elif isinstance(op, PackedGRM):
            self.op = PackedGRM(
                codes=put(jnp.pad(op.codes, ((0, 0), (0, pad))), self._mat),
                af=put(op.af, repl), inv=put(op.inv, repl),
                diag=put(jnp.pad(op.diag, (0, pad)), self._vec),
                miss_var=put(op.miss_var, repl),
                miss_samp=put(op.miss_samp, repl),
                miss_pad=put(op.miss_pad, repl),
                samp_mask=put(jnp.pad(op.samp_mask, (0, pad)), self._vec),
                n_variants=op.n_variants, n_samples=Np)
        else:
            raise TypeError(f"cannot shard {type(op).__name__}")
        self.n_variants = op.n_variants
        self.n_samples = N  # original size, what callers reason about

    @classmethod
    def from_streamed_blocks(cls, block_iter, n_samples: int, mesh: Mesh,
                             axis: str = "data"):
        """Build the sample-sharded packed operator DIRECTLY from streamed
        (idx, int8 codes) blocks: each bf16 block is padded to the
        mesh-aligned width and placed with the sample sharding as it
        arrives — the full [M, Np] store never exists unsharded on one
        device (the plain ``ShardedGrmHandle(build_packed_grm_streamed(...),
        mesh)`` route would OOM a single device at exactly the scale the
        mesh is for)."""
        from ..ops.packed_grm import PackedGRM, build_packed_grm_streamed

        nd = mesh.devices.size
        N = n_samples
        Np = -(-N // nd) * nd
        mat = NamedSharding(mesh, P(None, axis))

        def put_block(blk):          # host bf16 [b, N] -> sharded [b, Np]
            blk = np.pad(blk, ((0, 0), (0, Np - N)))
            return jax.device_put(blk, mat)

        op = build_packed_grm_streamed(block_iter, n_samples=N,
                                       device_put=put_block)
        self = cls.__new__(cls)
        self.mesh, self.axis = mesh, axis
        self.n_orig, self.n_padded = N, Np
        self._mat = mat
        self._vec = NamedSharding(mesh, P(axis))
        self._cols = NamedSharding(mesh, P(axis, None))
        repl = NamedSharding(mesh, P())

        def put(x, sh):
            return jax.device_put(jnp.asarray(x), sh)

        self.op = PackedGRM(
            codes=op.codes,          # already [M, Np], sample-sharded
            af=put(op.af, repl), inv=put(op.inv, repl),
            diag=put(jnp.pad(op.diag, (0, Np - N)), self._vec),
            miss_var=put(op.miss_var, repl),
            miss_samp=put(op.miss_samp, repl),
            miss_pad=put(op.miss_pad, repl),
            samp_mask=put(jnp.pad(op.samp_mask, (0, Np - N)), self._vec),
            n_variants=op.n_variants, n_samples=Np)
        self.n_variants = op.n_variants
        self.n_samples = N
        return self

    def _pad_put(self, x, fill, sharding):
        x = np.asarray(x, np.float64)
        pad = self.n_padded - self.n_orig
        if pad:
            widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
            x = np.pad(x, widths, constant_values=fill)
        return jax.device_put(jnp.asarray(x), sharding)

    def pcg(self, w, tau, B, tol, maxiter):
        """Solve Sigma X = B sharded; returns (X, converged) numpy."""
        from ..ops.pcg import pcg_solve_op
        squeeze = np.ndim(B) == 1
        Bp = self._pad_put(B[:, None] if squeeze else B, 0.0, self._cols)
        wp = self._pad_put(w, 1.0, self._vec)
        X, _, conv = pcg_solve_op(self.op, wp, jnp.asarray(tau), Bp,
                                  tol, maxiter)
        X = np.asarray(X)[: self.n_orig]
        return (X[:, 0] if squeeze else X), conv

    def mv(self, b):
        """GRM @ b sharded; original-size numpy in/out."""
        squeeze = np.ndim(b) == 1
        bp = self._pad_put(b[:, None] if squeeze else b, 0.0, self._cols)
        out = np.asarray(self.op.matvec(bp))[: self.n_orig]
        return out[:, 0] if squeeze else out


def replicate(mesh: Mesh, tree):
    """Replicate model state across the mesh."""
    full = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(jnp.asarray(x), full)
        if isinstance(x, (np.ndarray, jnp.ndarray)) else x, tree)
