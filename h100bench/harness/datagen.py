"""Counts drawn on the device from the run's seed: a gamma-Poisson
(negative binomial) generator with heavy-tailed per-gene means and per-cell
library sizes, as scRNA-seq UMI counts are modelled.

    mu_j ~ max(exp(log_mean + log_mean_sd z_j), mean_floor)   per gene
    l_i  ~ exp(library_sd z_i - library_sd^2 / 2)             per cell
    g_ij ~ Gamma(dispersion, 1 / dispersion)                 (a sum of
                                                              exponentials)
    x_ij ~ Poisson(l_i mu_j g_ij)

The parameters live in the configuration's ``data`` group; its
``log_mean`` was solved for a 3% share of nonzero cells. The same seed
gives the same counts on the same device; the training rows come first and
any held-out rows after them, from the one stream.

``posterior`` draws a scoring cell's surrogate posterior from the seed:
each raw parameter of the initial surrogate moved by a uniform draw of up
to ``spread``."""
from __future__ import annotations

import numpy as np
import torch


def counts(data, genes, rows, seed, device, block_rows=4096):
    """A (rows, genes) float32 count matrix on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    f32 = torch.float32
    z = torch.randn((genes,), generator=gen, dtype=f32, device=device)
    mu = torch.clamp_min(torch.exp(data["log_mean"] + data["log_mean_sd"] * z),
                         data["mean_floor"])
    sd = data["library_sd"]
    lib = torch.exp(sd * torch.randn((rows, 1), generator=gen, dtype=f32,
                                     device=device) - 0.5 * sd * sd)
    r = int(data["dispersion"])
    out = torch.empty((rows, genes), dtype=f32, device=device)
    for lo in range(0, rows, block_rows):
        hi = min(lo + block_rows, rows)
        g = torch.zeros((hi - lo, genes), dtype=f32, device=device)
        for _ in range(r):
            # 1 - U lies in (0, 1]: the log never meets 0
            g -= torch.log1p(-torch.rand((hi - lo, genes), generator=gen,
                                         dtype=f32, device=device))
        out[lo:hi] = torch.poisson(lib[lo:hi] * mu * (g / r), generator=gen)
    return out


def to_csr(x, block_rows=4096):
    """Host CSR arrays (indptr int64, indices int64, data float64) of a
    dense count matrix on the device, built there in row blocks."""
    counts_per_row, cols, vals = [], [], []
    for lo in range(0, x.shape[0], block_rows):
        blk = x[lo:lo + block_rows]
        nz = blk != 0
        counts_per_row.append(nz.sum(1))
        cols.append(nz.nonzero()[:, 1].to(torch.int32))
        vals.append(blk[nz])
    indptr = np.zeros(x.shape[0] + 1, np.int64)
    indptr[1:] = np.cumsum(torch.cat(counts_per_row).cpu().numpy())
    return (indptr, torch.cat(cols).cpu().numpy().astype(np.int64),
            torch.cat(vals).cpu().numpy().astype(np.float64))


def dense_rows(csr, rows, genes, device, dtype=torch.float64):
    """The dense rows ``rows`` (host int array) of host CSR arrays, on
    ``device``."""
    indptr, indices, data = csr
    rows = np.asarray(rows, np.int64)
    lo, hi = indptr[rows], indptr[rows + 1]
    n = hi - lo
    pos = np.repeat(lo - np.cumsum(n) + n, n) + np.arange(int(n.sum()))
    out = torch.zeros((len(rows), genes), dtype=dtype, device=device)
    r = torch.as_tensor(np.repeat(np.arange(len(rows)), n), device=device)
    c = torch.as_tensor(indices[pos], device=device)
    out[r, c] = torch.as_tensor(data[pos], dtype=dtype, device=device)
    return out


def posterior(init, seed, spread, device):
    """``init`` ({name: {leaf: float32 array}}) with every element moved by
    ``spread`` (2 U - 1), U uniform on the device from ``seed``, in one
    draw: float32 numpy arrays of the same structure."""
    leaves = [(n, k) for n in init for k in init[n]]
    flat = np.concatenate([np.asarray(init[n][k], np.float32).ravel()
                           for n, k in leaves])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand((flat.size,), generator=gen, dtype=torch.float32,
                   device=device)
    moved = (torch.as_tensor(flat, device=device)
             + np.float32(spread) * (2.0 * u - 1.0)).cpu().numpy()
    out, off = {}, 0
    for n, k in leaves:
        shape = np.shape(init[n][k])
        size = int(np.prod(shape))
        out.setdefault(n, {})[k] = moved[off:off + size].reshape(shape)
        off += size
    return out
