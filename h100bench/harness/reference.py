"""The plain reference of the scRNA Poisson factorization: its first
training steps and its held-out scoring, in plain PyTorch, written from the
model's equations. It imports nothing of the program and takes nothing the
program made: the initial surrogate, the column statistics, the random
draws and the epoch's permutation are worked out again here from the seed
and the counts.

Model (horseshoe+ priors, log link, rows and columns scaled):

    theta = log(x / eta + 1) @ (w1 * u) * rowsum(x) / xi,  w = s / colsum(s)
    rate  = exp((theta @ v) * eta) - 1 + eta * w2 * w
    x     ~ Poisson(rate), clipped as the reference engine clips it

A training step draws S samples of the mean-field surrogate (one Normal
block from the engine's generator, one InverseGamma block through the
Philox-keyed boosted Wilson-Hilferty sampler, drawn here again from the
same counter-based stream), takes -ELBO / rows, its gradient by autograd,
clips each element and takes an Adam step. Scoring draws posterior samples
in chunks and takes each row's log-mean-exp over them.

The training reference runs in float64. The scoring reference runs in
float32, the configuration's precision, with the sums over genes and
samples in float64: a score's error in float32 comes mostly from
``exp(a) - 1`` at the small ``a`` of such a posterior, which any float32
implementation rounds alike, so only a float32 reference sees past it to
the products. ``tf32`` set makes either the control: the same computation
with TF32 products (cuBLAS's on the card; on the CPU, operands rounded to
TF32 to nearest, which the card's readings match).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32_TINY = float(np.finfo(np.float32).tiny)
#: the gamma draw's floor (the float32 model's)
GAMMA_FLOOR = F32_TINY ** 0.5
#: the clip bound's floor of the float32 likelihood
CLIP_FLOOR = -1e27
LOG_2PI = math.log(2.0 * math.pi)
HALF_LOG_2_OVER_PI = 0.5 * math.log(2.0 / math.pi)
BOOST = 8
SQRT2 = 1.4142135623730951
#: the epochs whose permutations the engine draws at once
PERM_EPOCHS = 8

#: the surrogate's two blocks, each in the program's draw order
NORMALS = ("v", "w", "u", "s")
IGS = ("u_eta", "u_tau", "s_eta", "s_tau", "u_eta_a", "u_tau_a", "s_eta_a",
       "s_tau_a")


#: what this reference follows of a configuration: the model's class, the
#: model's keyword arguments with their values, and the fit's settings. A
#: configuration that asks for anything else needs a reference of its own
#: (and a kind of cell that uses it: ``kinds/``).
FOLLOWS = {"class": ("PoissonMatrixFactorization",),
           "kwargs": {"scale_rates": True, "log_transform": True,
                      "likelihood_clip": "reference",
                      "gamma_sampler": "fused"},
           "fit": ("sample_size", "learning_rate", "clip_value")}


def unfollowed(config):
    """What of ``config`` this reference does not follow (empty when it
    follows all of it)."""
    m = config["model"]
    out = []
    if m.get("class") not in FOLLOWS["class"]:
        out.append(f"model class {m.get('class')!r}")
    if m.get("dtype", "float32") != "float32":
        out.append(f"dtype {m['dtype']!r}")
    for k, v in m.get("kwargs", {}).items():
        if FOLLOWS["kwargs"].get(k, object()) != v:
            out.append(f"model keyword {k}={v!r}")
    out += [f"fit keyword {k}" for k in config.get("fit", {})
            if k not in FOLLOWS["fit"]]
    return out


def require_followed(config):
    """Raise ``ValueError`` naming what this reference does not follow."""
    missing = unfollowed(config)
    if missing:
        raise ValueError("the reference (harness/reference.py) does not "
                         "follow " + ", ".join(missing) + ": such a "
                         "configuration needs a reference and a kind of "
                         "its own")


# ------------------------------------------------------------------ setup
def _sp_inv(y):
    y = np.asarray(y, np.float64)
    return y + np.log(-np.expm1(-y))


def init_params(D, K, u_tau_scale, s_tau_scale=1.0):
    """The surrogate's initial parameters of a float32 model, as float32
    numpy arrays: {name: {leaf: array}}."""
    f32 = np.float32
    one = lambda *shape: np.ones(shape, f32)  # noqa: E731

    def normal(loc, scale):
        return {"loc": np.asarray(loc, f32),
                "raw_scale": _sp_inv(scale).astype(f32)}

    def inv_gamma(conc, scale):
        return {"raw_concentration": _sp_inv(conc).astype(f32),
                "raw_scale": _sp_inv(scale).astype(f32)}

    return {
        "v": normal(-6.0 * one(K, D), 5e-4 * one(K, D)),
        "w": normal(-6.0 * one(1, D), 5e-4 * one(1, D)),
        "u": normal(-6.0 * one(D, K), 5e-4 * one(D, K)),
        "u_eta": inv_gamma(3.0 * one(D, K), one(D, K)),
        "u_tau": inv_gamma(3.0 * one(1, K), one(1, K)),
        "s_eta": inv_gamma(one(2, D), one(2, D)),
        "s_tau": inv_gamma(one(1, D), one(1, D)),
        "s": normal(one(2, D) * np.asarray([[-2.0], [-1.0]], f32),
                    1e-3 * one(2, D)),
        "u_eta_a": inv_gamma(2.0 * one(D, K), one(D, K)),
        "u_tau_a": inv_gamma(2.0 * one(1, K),
                             one(1, K) / f32(u_tau_scale ** 2)),
        "s_eta_a": inv_gamma(2.0 * one(2, D), one(2, D)),
        "s_tau_a": inv_gamma(2.0 * one(1, D),
                             one(1, D) / f32(s_tau_scale ** 2)),
    }


def column_stats(x_blocks):
    """(column sums, columns' nonzero counts) in float64 over an iterable
    of count blocks."""
    colsum = nnz = None
    for x in x_blocks:
        x = x.to(torch.float64)
        cs, nz = x.sum(0), (x > 0).sum(0).to(torch.float64)
        colsum = cs if colsum is None else colsum + cs
        nnz = nz if nnz is None else nnz + nz
    return colsum.cpu().numpy(), nnz.cpu().numpy()


def xi_global(colsum, nnz):
    """The row scale's global: the sum over genes of the mean of each
    gene's nonzero counts, as the float32 model holds it."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.float32(np.nansum(colsum / nnz)))


# ------------------------------------------------------------------ maths
def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _pos(x):
    """softplus floored at float32's tiny (the model's Softplus bijector)."""
    return torch.clamp_min(softplus(x), F32_TINY)


def _round_tf32(x):
    """float32 rounded to TF32's 10 mantissa bits, to nearest."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _tf32_matmul(mode):
    """A matmul, and its backward's two, in TF32: the card's cuBLAS with
    TF32 on ('cublas'), or float32 products of operands rounded to TF32
    ('rn', for the CPU, which has no TF32)."""
    def mm(a, b):
        if mode == "rn":
            return torch.matmul(_round_tf32(a), _round_tf32(b))
        flag = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return torch.matmul(a, b)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = flag

    class MatMul(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, b):
            ctx.save_for_backward(a, b)
            return mm(a, b)

        @staticmethod
        def backward(ctx, g):
            a, b = ctx.saved_tensors
            return (mm(g, b.transpose(-1, -2)).sum_to_size(a.shape),
                    mm(a.transpose(-1, -2), g).sum_to_size(b.shape))
    return MatMul.apply


def _matmul(tf32):
    """torch.matmul, or with ``tf32`` ('cublas' or 'rn') the control's TF32
    products."""
    return _tf32_matmul(tf32) if tf32 else torch.matmul


# ---------------------------------------------------------- Philox stream
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mulhilo(m, b):
    p_hi = m * (b >> 16)
    p_lo = m * (b & 0xFFFF)
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 (Random123) on int64 tensors of uint32 values."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _uniforms(total, stream, seed, dtype, device):
    """The 9 uniforms (9, total) of element i and stream s: Philox with key
    (seed, 0) and counter (i, s, j, 0), j = 0, 1, 2; U = (word >> 9) 2^-23
    + 2^-24."""
    idx = torch.arange(total, dtype=torch.int64, device=device)
    zero = torch.zeros_like(idx)
    words = []
    for j in range(3):
        words.extend(philox4x32(idx, zero + stream, zero + j, zero,
                                int(seed) & _MASK, 0))
    m = torch.stack(words[:BOOST + 1]) >> 9
    return m.to(dtype) * 2.0 ** -23 + 2.0 ** -24


def ig_block(a, b, seed, S):
    """S draws of softplus(InverseGamma(a, b)) by the boosted
    Wilson-Hilferty gamma G (x = b / G), and each draw's summed
    log q(x) - log softplus'(x): (S, total), (S,). Differentiable in a and
    b (the uniforms are constants)."""
    logb = torch.log(b)
    t0 = a * logb - torch.lgamma(a)
    i = torch.arange(BOOST, dtype=a.dtype, device=a.device)[:, None]
    w = 1.0 / (a + i)
    ab = a + float(BOOST)
    ys, lqs = [], []
    for s in range(S):
        u = _uniforms(a.shape[0], s, seed, a.dtype, a.device)
        eps = SQRT2 * torch.erfinv(2.0 * u[0] - 1.0)
        s1 = torch.sum(torch.log(u[1:]) * w, 0)
        c = 1.0 - 1.0 / (9.0 * ab) + eps / (3.0 * torch.sqrt(ab))
        g = torch.clamp_min(ab * torch.clamp_min(c, 0.05) ** 3 * torch.exp(s1),
                            GAMMA_FLOOR)
        x = b / g
        ys.append(softplus(x))
        lqs.append(torch.sum(t0 - (a + 1.0) * (logb - torch.log(g)) - g
                             + softplus(-x)))
    return torch.stack(ys), torch.stack(lqs)


# ------------------------------------------------------------- the model
class Model:
    """The configuration's constants: D, K, the scales, the column norms
    ``eta`` (1, D) and the row scale's ``xi``, in ``dtype`` on ``device``."""

    def __init__(self, D, K, u_tau_scale, eta, xi, dtype, device,
                 s_tau_scale=1.0, decay=0.99, tf32=False):
        self.D, self.K = D, K
        self.u_tau_scale, self.s_tau_scale = u_tau_scale, s_tau_scale
        self.dtype, self.device, self.tf32 = dtype, device, tf32
        self.mm = _matmul(tf32)
        # the float32 model's lanes, in the compute dtype
        self.eta = torch.as_tensor(np.asarray(eta, np.float32).reshape(1, D),
                                   device=device).to(dtype)
        self.xi = float(np.float32(xi))
        self.decay = torch.as_tensor(
            np.asarray(decay, np.float32) ** np.arange(K, dtype=np.float32),
            device=device).to(dtype)[None, :]

    def params(self, init):
        """Leaves of ``init`` (numpy) in the compute dtype, with grad."""
        return {n: {k: torch.as_tensor(a, device=self.device).to(self.dtype)
                    .requires_grad_(True) for k, a in sub.items()}
                for n, sub in init.items()}

    # --------------------------------------------------------- the draw
    def draw(self, params, gen, S):
        """S samples of every variable and their log q: the Normal block's
        standard normals from ``gen``, then the InverseGamma block's seed
        from ``gen`` (the engine's order)."""
        dev = gen.device
        total = sum(params[n]["loc"].numel() for n in NORMALS)
        eps = torch.randn((S, total), generator=gen, dtype=torch.float32,
                          device=dev).to(device=self.device, dtype=self.dtype)
        values, logq, scale_log, off = {}, 0.0, 0.0, 0
        for n in NORMALS:
            p = params[n]
            shape = tuple(p["loc"].shape)
            e = eps[:, off:off + p["loc"].numel()].reshape((S,) + shape)
            off += p["loc"].numel()
            scale = _pos(p["raw_scale"])
            x = p["loc"] + scale * e
            scale_log = scale_log + torch.sum(torch.log(scale))
            logq = logq - torch.sum(F.logsigmoid(x), dim=(-1, -2))
            values[n] = _pos(x)
        logq = logq - 0.5 * torch.sum(eps * eps, -1) - scale_log \
            - 0.5 * total * LOG_2PI
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen,
                                 dtype=torch.int32, device=dev)[0])
        a = torch.cat([_pos(params[n]["raw_concentration"]).reshape(-1)
                       for n in IGS])
        b = torch.cat([_pos(params[n]["raw_scale"]).reshape(-1) for n in IGS])
        y, lq = ig_block(a, b, seed, S)
        off = 0
        for n in IGS:
            shape = tuple(params[n]["raw_scale"].shape)
            size = params[n]["raw_scale"].numel()
            values[n] = y[:, off:off + size].reshape((S,) + shape)
            off += size
        return values, logq + lq

    # -------------------------------------------------------- the energy
    def prior(self, t):
        """The priors' log density summed, (S,)."""
        def hn(x, scale):
            return torch.sum(HALF_LOG_2_OVER_PI - torch.log(scale)
                             - 0.5 * (x / scale) ** 2, dim=(-1, -2))

        def ig(x, a, b):
            return torch.sum(a * torch.log(b) - (a + 1.0) * torch.log(x)
                             - b / x - math.lgamma(a), dim=(-1, -2))

        def sqrt_ig(x, a, b):
            logx, logb = torch.log(x), torch.log(b)
            return torch.sum(a * logb - (2.0 * a + 1.0) * logx
                             - torch.exp(logb - 2.0 * logx) - math.lgamma(a)
                             + math.log(2.0), dim=(-1, -2))

        one = torch.ones((), dtype=self.dtype, device=self.device)
        return (hn(t["v"], 0.1 * one) + hn(t["w"], one)
                + hn(t["u"], t["u_eta"] * t["u_tau"] * self.decay)
                + sqrt_ig(t["u_eta"], 0.5, 1.0 / t["u_eta_a"])
                + ig(t["u_eta_a"], 0.5, one)
                + sqrt_ig(t["u_tau"], 0.5, 1.0 / t["u_tau_a"])
                + ig(t["u_tau_a"], 0.5, one / self.u_tau_scale ** 2)
                + hn(t["s"], t["s_eta"] * t["s_tau"])
                + sqrt_ig(t["s_eta"], 0.5, 1.0 / t["s_eta_a"])
                + ig(t["s_eta_a"], 0.5, one)
                + sqrt_ig(t["s_tau"], 0.5, 1.0 / t["s_tau_a"])
                + ig(t["s_tau_a"], 0.5, one / self.s_tau_scale ** 2))

    def encode(self, t, x):
        """theta (S, B, K) and phi (S, 1, D)."""
        weights = t["s"] / torch.sum(t["s"], dim=-2, keepdim=True)
        A = weights[:, 0, :, None] * t["u"]
        gx = torch.log(x / self.eta + 1.0)
        theta = self.mm(gx, A) * (torch.sum(x, -1, keepdim=True) / self.xi)
        phi = self.eta * weights[:, 1:2, :] * t["w"]
        return theta, phi

    def _cells(self, theta, v, phi, x, lgx):
        """Every cell's Poisson log-likelihood of one sample, (B, D)."""
        rate = torch.exp(self.mm(theta, v) * self.eta) - 1.0 + phi
        return x * torch.log(rate) - rate - lgx

    def _clipped_sum(self, theta, v, phi, x, lgx):
        ll = self._cells(theta, v, phi, x, lgx)
        keep = torch.isfinite(ll) & (ll > CLIP_FLOOR)
        fin = torch.where(torch.isfinite(ll), ll, torch.zeros_like(ll))
        return (torch.sum(torch.where(keep, torch.clamp_max(ll, 0.0),
                                      torch.zeros_like(ll))),
                torch.sum(~keep).to(ll.dtype), torch.min(fin).detach())

    def energy(self, t, x):
        """Unnormalised log density of a batch at each sample, (S,): the
        priors, theta's HalfNormal(1) prior and the clipped likelihood
        (the bound max(min(finite ll) - 10, -1e27), a constant to the
        gradient, takes the cells that are not finite)."""
        theta, phi = self.encode(t, x)
        z = torch.sum(HALF_LOG_2_OVER_PI - 0.5 * theta ** 2, dim=(-1, -2))
        lgx = torch.lgamma(x + 1.0)
        parts = [checkpoint(self._clipped_sum, theta[s], t["v"][s], phi[s],
                            x, lgx, use_reentrant=False)
                 for s in range(theta.shape[0])]
        sums = torch.stack([p[0] for p in parts])
        cnt = torch.stack([p[1] for p in parts])
        m = torch.clamp_min(torch.stack([p[2] for p in parts]).min() - 10.0,
                            CLIP_FLOOR)
        return self.prior(t) + z + sums + cnt * m

    def loss(self, params, x, gen, S):
        t, logq = self.draw(params, gen, S)
        return -torch.mean(self.energy(t, x) - logq) / x.shape[0]

    # -------------------------------------------------------- scoring
    @torch.no_grad()
    def row_loglik(self, t, x):
        """Each row's log-likelihood at each sample, (S, B), unclipped: the
        cells in the compute dtype, their sum over genes in float64."""
        theta, phi = self.encode(t, x)
        lgx = torch.lgamma(x + 1.0)
        return torch.stack([torch.sum(self._cells(
            theta[s], t["v"][s], phi[s], x, lgx).to(torch.float64), -1)
            for s in range(theta.shape[0])])


def train_steps(model, init, rows_of, n_rows, B, S, steps, seed, lr, clip,
                gen_device):
    """The engine's first ``steps`` steps of a fit over ``n_rows`` rows in
    batches of B from the engine seed ``seed``: the initial loss of the
    first rows, the epoch's permutation, then per step the batch, the
    draws, the loss, the clipped gradient and Adam (b1 0.9, b2 0.999, eps
    1e-8). ``rows_of(index tensor)`` gives the rows' counts in the compute
    dtype on the model's device. Returns the initial loss, the steps'
    losses, and per leaf the parameters and Adam's moments after them."""
    gen = torch.Generator(device=gen_device).manual_seed(int(seed))
    p = model.params(init)
    leaves = [(n, k) for n in p for k in p[n]]
    with torch.no_grad():
        initial = float(model.loss(p, rows_of(torch.arange(B)), gen, S))
    keys = torch.rand((PERM_EPOCHS, n_rows), generator=gen,
                      dtype=torch.float64, device=gen_device)
    perm = torch.argsort(keys, dim=1)[0].cpu()
    m = {nk: torch.zeros_like(p[nk[0]][nk[1]]) for nk in leaves}
    v = {nk: torch.zeros_like(p[nk[0]][nk[1]]) for nk in leaves}
    losses = []
    for step in range(1, steps + 1):
        x = rows_of(perm[(step - 1) * B:step * B])
        loss = model.loss(p, x, gen, S)
        grads = torch.autograd.grad(loss, [p[n][k] for n, k in leaves])
        losses.append(float(loss.detach()))
        bc1, bc2 = 1.0 - 0.9 ** step, 1.0 - 0.999 ** step
        with torch.no_grad():
            for (n, k), g in zip(leaves, grads):
                g = g.clamp(-clip, clip)
                m[n, k] = 0.9 * m[n, k] + 0.1 * g
                v[n, k] = 0.999 * v[n, k] + 0.001 * g * g
                p[n][k] -= (lr / bc1) * m[n, k] / (
                    torch.sqrt(v[n, k]) / math.sqrt(bc2) + 1e-8)
        del loss, grads
    return {"initial": initial, "losses": losses,
            "params": {nk: p[nk[0]][nk[1]].detach() for nk in leaves},
            "exp_avg": m, "exp_avg_sq": v}


def score_draws(model, params, seed, num_samples, chunk, gen_device):
    """The posterior draws of a scoring call: ``num_samples`` in chunks of
    ``chunk`` and a remainder, from a generator seeded ``seed``."""
    gen = torch.Generator(device=gen_device).manual_seed(int(seed))
    sizes = [chunk] * (num_samples // chunk)
    if num_samples % chunk:
        sizes.append(num_samples % chunk)
    p = {n: {k: torch.as_tensor(a, device=model.device).to(model.dtype)
             for k, a in sub.items()} for n, sub in params.items()}
    with torch.no_grad():
        return [model.draw(p, gen, s)[0] for s in sizes]


def lppd_rows(model, draws, x, block=4096):
    """Each row's log mean over samples of exp(its log-likelihood), in
    float64, (rows,): the rows of ``x`` in blocks of ``block``."""
    out = []
    for lo in range(0, x.shape[0], block):
        xb = x[lo:lo + block]
        ll = torch.cat([model.row_loglik(t, xb).to(torch.float64)
                        for t in draws])
        out.append(torch.logsumexp(ll, 0) - math.log(ll.shape[0]))
    return torch.cat(out)
