"""The plain reference of the deep Bayesian Poisson autoencoder
(mederrata/spmf ``mederrata_spmf/poisson.py:720-833``, ``PoissonAutoencoder``):
its energy and first training steps in plain PyTorch, written from the
model's equations. It imports nothing of the program and takes nothing the
program made: the initial surrogate, the column norms, the random draws and
the epoch's permutation are worked out again here from the seed and the
counts (the steps themselves: ``reference.train_steps``).

Model (layer widths ``[D] * encoder_layers + [K] + [D] * decoder_layers +
[D]``, ``d_0 = D``):

    h_0 = x / eta;  h_l = a(h_{l-1} w_l + b_l), a = softplus, none after the
    last layer;  rate = exp(h_L) * eta;  x ~ Poisson(rate)
    w_l ~ Horseshoe(1 / sqrt(d_{l-1})) elementwise,  b_l ~ Normal(0, 1)

with the horseshoe's exact marginal density

    p(w) = (2 pi^3)^(-1/2) e^z E1(z) / scale,   z = w^2 / (2 scale^2),

E1 from its power series below z = 2 and its continued fraction above. The
surrogate is mean-field Normal over every weight and bias (loc 0, scale
0.1 / sqrt(d_{l-1}) for weights and 1e-3 for biases, softplus-parameterised
and floored at float32's tiny), drawn as ONE standard-normal block from the
engine's generator in the order w_0, b_0, w_1, b_1, ... A step takes
``-mean_s(prior_weight * log prior + log lik - log q) / rows``, its gradient
by autograd, clips each element and takes an Adam step.

Where it departs from ``mederrata_spmf/poisson.py:720-833``:

- the reference's ``__init__`` calls ``super(PoissonAutoencoder, self)`` with
  arguments its base does not take, so it cannot be built as written; this
  follows what the class means to build, as the program does;
- the reference takes the column norms from the first batch's means, and a
  gene with no count there gives ``x / 0``; here (and in the cell) each
  gene's mean over all rows, 1 for a gene with none;
- z is floored at float32's tiny, as the float32 model floors it, so that
  the density's log singularity at w = 0 stays finite (no draw reaches it);
- the Poisson log-likelihood is ``x log(rate) - rate - lgamma(x + 1)``
  unfloored: the program floors ``log(rate)`` at float32's tiny, which no
  cell's rates reach.

It runs in float64 on the card. ``tf32`` set makes it the control: the
same computation in float32 with TF32 products (``reference._matmul``).
Torch's own TF32 switches are set off while the module loads, so that only
the control's products are TF32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from harness import reference

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EULER_GAMMA = 0.5772156649015329
#: log((2 pi^3)^(-1/2)), the horseshoe density's constant
LOG_HORSESHOE_K = -0.5 * math.log(2.0 * math.pi ** 3)
#: E1 by its series below this z, by its continued fraction from it
SERIES_BELOW = 2.0
SERIES_TERMS = 40
FRACTION_TERMS = 60

#: what this reference follows of a configuration (``reference.FOLLOWS``'s
#: form): a configuration that asks for anything else needs a reference of
#: its own
FOLLOWS = {"class": ("PoissonAutoencoder",),
           "kwargs": {"encoder_layers": 1, "decoder_layers": 1},
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
    kwargs = m.get("kwargs", {})
    for k in set(kwargs) | set(FOLLOWS["kwargs"]):
        if FOLLOWS["kwargs"].get(k, object()) != kwargs.get(k, object()):
            out.append(f"model keyword {k}={kwargs.get(k)!r}")
    out += [f"fit keyword {k}" for k in config.get("fit", {})
            if k not in FOLLOWS["fit"]]
    return out


def require_followed(config):
    """Raise ``ValueError`` naming what this reference does not follow."""
    missing = unfollowed(config)
    if missing:
        raise ValueError("the reference (harness/ae_reference.py) does not "
                         "follow " + ", ".join(missing))


def layer_sizes(D, K, encoder_layers=1, decoder_layers=1):
    return [D] * encoder_layers + [K] + [D] * decoder_layers + [D]


def init_params(D, sizes):
    """The surrogate's initial parameters of a float32 model, as float32
    numpy arrays: {name: {leaf: array}} in the draw order."""
    f32 = np.float32
    dims = [D] + list(sizes)
    out = {}
    for l, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        for name, shape, scale in ((f"w_{l}", (d_in, d_out),
                                    0.1 / math.sqrt(d_in)),
                                   (f"b_{l}", (1, d_out), 1e-3)):
            out[name] = {"loc": np.zeros(shape, f32),
                         "raw_scale": np.full(shape, reference._sp_inv(
                             f32(scale)), f32)}
    return out


# ------------------------------------------------------------------ E1
def _series_e1(z):
    """E1(z) = -gamma - log z - sum_k (-z)^k / (k k!), for z < 2."""
    total = torch.zeros_like(z)
    term = torch.ones_like(z)
    for k in range(1, SERIES_TERMS + 1):
        term = term * (-z) / k
        total = total + term / k
    return -EULER_GAMMA - torch.log(z) - total


def _fraction_h(z):
    """e^z E1(z) = 1 / (z + 1 - 1 / (z + 3 - 4 / (z + 5 - ...))), evaluated
    from its tail, for z >= 2."""
    t = torch.zeros_like(z)
    for n in range(FRACTION_TERMS, 0, -1):
        t = (n * n) / (z + (2 * n + 1) - t)
    return 1.0 / (z + 1.0 - t)


def scaled_e1(z):
    """h(z) = e^z E1(z), z > 0."""
    small = torch.clamp_max(z, SERIES_BELOW)
    return torch.where(z < SERIES_BELOW,
                       torch.exp(small) * _series_e1(small),
                       _fraction_h(torch.clamp_min(z, SERIES_BELOW)))


class _LogE1(torch.autograd.Function):
    """log E1(z) = log h(z) - z, with d/dz log E1(z) = -e^{-z} / (z E1(z))
    = -1 / (z h(z)). It keeps z and h for the backward, none of the
    series' or the fraction's terms."""

    @staticmethod
    def forward(ctx, z):
        h = scaled_e1(z)
        ctx.save_for_backward(z, h)
        return torch.log(h) - z

    @staticmethod
    def backward(ctx, grad):
        z, h = ctx.saved_tensors
        return -grad / (z * h)


def log_e1(z):
    return _LogE1.apply(z)


def horseshoe_log_prob(w, scale):
    """The horseshoe's exact log density, elementwise."""
    z = torch.clamp_min(torch.square(w / scale) / 2.0, reference.F32_TINY)
    return LOG_HORSESHOE_K - math.log(scale) + z + log_e1(z)


# ------------------------------------------------------------- the model
class Model:
    """The configuration's constants: D, the layer widths, the column norms
    ``eta`` (1, D) and the prior's weight, in ``dtype`` on ``device``.
    ``model_dtype``: the program's dtype, in which the draws are made and
    to which its constants (``eta``, the prior's scales) are rounded."""

    def __init__(self, D, sizes, eta, dtype, device, prior_weight=1.0,
                 tf32=False, model_dtype=torch.float32):
        self.D, self.sizes = D, list(sizes)
        self.dims = [D] + self.sizes
        self.dtype, self.device = dtype, device
        self.model_dtype = model_dtype
        self._np_model = np.float32 if model_dtype == torch.float32 \
            else np.float64
        self.prior_weight = float(prior_weight)
        self.mm = reference._matmul(tf32)
        # the model's norms, in the compute dtype
        self.eta = torch.as_tensor(
            np.asarray(eta, self._np_model).reshape(1, D),
            device=device).to(dtype)

    def names(self):
        return [f"{p}_{l}" for l in range(len(self.sizes)) for p in "wb"]

    def params(self, init):
        """Leaves of ``init`` (numpy) in the compute dtype, with grad."""
        return {n: {k: torch.as_tensor(a, device=self.device).to(self.dtype)
                    .requires_grad_(True) for k, a in sub.items()}
                for n, sub in init.items()}

    def draw(self, params, gen, S):
        """S samples of every weight and bias and their log q: one block
        of standard normals from ``gen`` in the draw order (drawn in the
        model's dtype, as the program draws it)."""
        names = self.names()
        total = sum(params[n]["loc"].numel() for n in names)
        eps = torch.randn((S, total), generator=gen, dtype=self.model_dtype,
                          device=gen.device).to(device=self.device,
                                                dtype=self.dtype)
        values, scale_log, off = {}, 0.0, 0
        for n in names:
            p = params[n]
            size = p["loc"].numel()
            e = eps[:, off:off + size].reshape((S,) + tuple(p["loc"].shape))
            off += size
            scale = reference._pos(p["raw_scale"])
            values[n] = p["loc"] + scale * e
            scale_log = scale_log + torch.sum(torch.log(scale))
        logq = (-0.5 * torch.sum(eps * eps, -1) - scale_log
                - 0.5 * total * reference.LOG_2PI)
        return values, logq

    def prior(self, t):
        """Each sample's log prior, (S,)."""
        out = 0.0
        for l, d_in in enumerate(self.dims[:-1]):
            # the model's scale
            scale = float(self._np_model(1.0 / math.sqrt(d_in)))
            out = out + torch.sum(horseshoe_log_prob(t[f"w_{l}"], scale),
                                  dim=(-1, -2))
            b = t[f"b_{l}"]
            out = out + torch.sum(-0.5 * b * b - 0.5 * reference.LOG_2PI,
                                  dim=(-1, -2))
        return out

    def log_rate(self, t, x):
        """The network's output, log(rate) - log(eta): (S, B, D)."""
        h = x / self.eta
        last = len(self.sizes) - 1
        for l in range(last + 1):
            h = self.mm(h, t[f"w_{l}"]) + t[f"b_{l}"]
            if l < last:
                h = reference.softplus(h)
        return h

    def likelihood(self, t, x):
        """Each sample's Poisson log-likelihood of the batch, (S,)."""
        rate = torch.exp(self.log_rate(t, x)) * self.eta
        return torch.sum(x * torch.log(rate) - rate - torch.lgamma(x + 1.0),
                         dim=(-1, -2))

    def energy(self, t, x):
        return self.prior_weight * self.prior(t) + self.likelihood(t, x)

    def loss(self, params, x, gen, S):
        t, logq = self.draw(params, gen, S)
        return -torch.mean(self.energy(t, x) - logq) / x.shape[0]
