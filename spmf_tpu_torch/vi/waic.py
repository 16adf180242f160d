"""WAIC (widely applicable information criterion), mirroring
spmf_tpu/vi/waic.py.

``waic = -2 * (lppd - pwaic)`` with ``lppd = sum_i log mean_s exp(ll_is)``
and ``pwaic = sum_i var_s(ll_is)`` over per-row log-likelihoods;
``se = sqrt(N * var_i(waic_i))``.

Posterior samples are drawn in chunks (default 8) and reduced with
streaming moments, so WAIC at production scale (D=20k, 100 samples) never
holds more than one (chunk, B) block of per-row log-likelihoods; the row
kernel behind the model's ``_row_log_likelihood`` never materialises
(S, B, D) either.

On a rank mesh each rank scores its rows of every batch (the model's
per-row sums run over its columns and are summed over the fp line), keeps
their per-row terms, and the terms of all rows are gathered over the row
ranks once, at the end: every rank returns the same result.
"""
from __future__ import annotations

import warnings
from typing import Callable

import numpy as np
import torch

from spmf_tpu_torch.parallel.mesh import shard_batch
from spmf_tpu_torch.utils.spans import span
from spmf_tpu_torch.vi.minibatch import _device_batch

__all__ = ["waic", "streaming_waic_terms"]


def streaming_waic_terms(ll_chunks) -> tuple:
    """Exact (lppd_i, pwaic_i) from an iterable of (S_c, B) per-row
    log-likelihood blocks over the SAME rows: accumulates the running
    log-sum-exp, sum and sum of squares in float64, so the result equals
    the one-shot formulas on the concatenated (S, B) matrix. Warns once if
    a block holds non-finite entries (the result will be non-finite)."""
    from scipy.special import logsumexp

    lse = None
    s1 = s2 = 0.0
    n = 0
    warned = False
    for ll in ll_chunks:
        with span("waic reduce"):
            ll = np.asarray(ll, np.float64)
            if not warned and not np.isfinite(ll).all():
                warned = True
                warnings.warn(
                    f"{int((~np.isfinite(ll)).sum())} non-finite per-row "
                    "log-likelihood values entered WAIC (chunk shape "
                    f"{ll.shape}); the result will be non-finite.",
                    RuntimeWarning,
                )
            c = logsumexp(ll, axis=0)
            lse = c if lse is None else np.logaddexp(lse, c)
            s1 = s1 + ll.sum(axis=0)
            s2 = s2 + (ll * ll).sum(axis=0)
            n += ll.shape[0]
    lppd_i = lse - np.log(float(n))
    mean = s1 / n
    pwaic_i = (s2 - n * mean * mean) / (n - 1)  # ddof=1
    return lppd_i, pwaic_i


@torch.no_grad()
def waic(
    row_log_likelihood_fn: Callable,  # (batch, samples) -> (S, B) per-row ll
    surrogate,
    params,
    batched_data_factory: Callable,
    num_samples: int = 100,
    seed: int = 1,
    dtype=torch.float32,
    sample_chunk: int = 8,
    *,
    device=None,
    mesh=None,
) -> dict:
    """Stream ``num_samples`` posterior draws per batch in chunks of
    ``sample_chunk`` plus one remainder chunk, all from one
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the surrogate's
    by default). Returns {'waic', 'se', 'lppd', 'pwaic', 'n_rows'}.
    ``mesh``: score each batch's part on this rank (see the module
    docstring). The positional order is spmf_tpu's; ``device`` and
    ``mesh``, the port's own, are keyword-only."""
    if mesh is not None:
        mesh.check_member("waic")
    if mesh is not None and mesh.trivial:
        mesh = None
    sample_chunk = min(sample_chunk, num_samples)
    n_chunks = num_samples // sample_chunk
    residual = num_samples - n_chunks * sample_chunk
    device = surrogate.device if device is None else device
    generator = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [sample_chunk] * n_chunks + ([residual] if residual else [])

    lppd_all, pwaic_all = [], []
    for batch in batched_data_factory():
        if mesh is not None:
            batch = shard_batch(batch, mesh)
        batch = _device_batch(batch, dtype, device)

        def chunks():
            # each chunk's draw, score and fetch; streaming_waic_terms
            # reduces it before the next chunk is drawn
            for s in sizes:
                with span("waic draw"):
                    samples = surrogate.sample(params, generator, (s,))
                with span("waic row_ll"):
                    ll = row_log_likelihood_fn(batch, samples)
                with span("waic fetch"):
                    ll = ll.cpu().numpy()
                yield ll

        lppd_i, pwaic_i = streaming_waic_terms(chunks())
        lppd_all.append(lppd_i)
        pwaic_all.append(pwaic_i)

    lppd_i = np.concatenate(lppd_all)
    pwaic_i = np.concatenate(pwaic_all)
    if mesh is not None and mesh.data_axes:
        both = torch.as_tensor(np.stack([lppd_i, pwaic_i], 1), device=device)
        both = mesh.gather(both, 0, mesh.data_axes).cpu().numpy()
        lppd_i, pwaic_i = both[:, 0], both[:, 1]
    waic_i = -2.0 * (lppd_i - pwaic_i)
    n = waic_i.shape[0]
    return {
        "waic": float(waic_i.sum()),
        "se": float(np.sqrt(n * waic_i.var())),
        "lppd": float(lppd_i.sum()),
        "pwaic": float(pwaic_i.sum()),
        # row count of the evaluated data: per-row scores without a second
        # data pass
        "n_rows": int(n),
    }
