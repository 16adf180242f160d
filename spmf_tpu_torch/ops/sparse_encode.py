"""Sparse encoder contraction: z = g(x) @ A over COO counts (mirrors
spmf_tpu/ops/sparse_encode.py).

Both encoder links satisfy g(0) = 0 (identity scale: 0/eta = 0; log
transform: log(0/eta + 1) = 0), so the contraction only touches nonzeros:

    z[r, k] = sum_{(r, c, v) in nnz} g(v; eta_c) * A[c, k]

as a gather of A's rows and an ``index_add_`` over the rows. The ELBO
sample axis is flattened into the gathered width, a (D, L*K) table, as in
the JAX module, so one gather and one scatter-add serve every sample.
"""
from __future__ import annotations

import torch

__all__ = ["sparse_encode_coo"]


def sparse_encode_coo(rows, cols, vals, num_rows, A, eta=1.0,
                      log_transform=False, xi_global=None):
    """Encode COO counts. Args:
      rows, cols, vals: (nnz,) COO triplets (zero padding is exact: g(0)=0
        and padded indices are in-bounds zeros)
      num_rows: row count of the output
      A: (..., D, K) encoding matrix (w1 * u); leading dims are ELBO samples
      eta: (1, D) or scalar column normalization
      xi_global: if given, apply the row scaling z *= rowsum(x) / xi_global
    Returns z: (..., num_rows, K), on A's device and in its dtype."""
    dev, dt = A.device, A.dtype
    rows = torch.as_tensor(rows, device=dev)
    cols = torch.as_tensor(cols, device=dev)
    vals = torch.as_tensor(vals, device=dev).to(dt)
    D, K = A.shape[-2], A.shape[-1]
    lead = A.shape[:-2]
    L = A[..., 0, 0].numel()
    eta_c = torch.as_tensor(eta, dtype=dt, device=dev).broadcast_to(
        (1, D))[0][cols]
    g = torch.log(vals / eta_c + 1.0) if log_transform else vals / eta_c
    A_flat = A.reshape(L, D, K).movedim(0, 1).reshape(D, L * K)
    contrib = g[:, None] * A_flat.index_select(0, cols)
    z_flat = torch.zeros((num_rows, L * K), dtype=dt, device=dev).index_add(
        0, rows, contrib)
    z = z_flat.reshape(num_rows, L, K).movedim(1, 0).reshape(
        lead + (num_rows, K))
    if xi_global is not None:
        rowsums = torch.zeros(num_rows, dtype=dt, device=dev).index_add(
            0, rows, vals)
        z = z * (rowsums / torch.as_tensor(xi_global, dtype=dt,
                                           device=dev))[:, None]
    return z
