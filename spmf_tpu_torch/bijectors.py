"""Bijectors with forward / inverse / log-det-Jacobian (mirrors
spmf_tpu/bijectors.py): Identity, Softplus, Exp and Chain."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["Bijector", "Identity", "Softplus", "Exp", "Chain", "softplus"]


def softplus(x):
    """log(1 + e^x) without torch's threshold cut-over (F.softplus returns x
    above 20, 1e-9 off): matches jax.nn.softplus, gradient sigmoid(x)."""
    return torch.logaddexp(x, torch.zeros_like(x))


class Bijector:
    def forward(self, x):  # pragma: no cover - interface
        raise NotImplementedError

    def inverse(self, y):  # pragma: no cover - interface
        raise NotImplementedError

    def forward_log_det_jacobian(self, x):  # pragma: no cover - interface
        raise NotImplementedError

    def inverse_log_det_jacobian(self, y):
        return -self.forward_log_det_jacobian(self.inverse(y))

    def __call__(self, x):
        return self.forward(x)


class Identity(Bijector):
    def forward(self, x):
        return x

    def inverse(self, y):
        return y

    def forward_log_det_jacobian(self, x):
        return torch.zeros_like(x)

    def inverse_log_det_jacobian(self, y):
        return torch.zeros_like(y)


class Softplus(Bijector):
    """y = log(1 + e^x), floored at the dtype's tiny (see the JAX
    Softplus: an exact zero would poison the s-split normalization and the
    horseshoe+ 1/u_eta_a scales with inf/NaN gradients)."""

    def forward(self, x):
        y = softplus(x)
        return torch.clamp_min(y, torch.finfo(y.dtype).tiny)

    def inverse(self, y):
        return y + torch.log(-torch.expm1(-y))

    def forward_log_det_jacobian(self, x):
        return F.logsigmoid(x)

    def inverse_log_det_jacobian(self, y):
        return -torch.log(-torch.expm1(-y))


class Exp(Bijector):
    def forward(self, x):
        return torch.exp(x)

    def inverse(self, y):
        return torch.log(y)

    def forward_log_det_jacobian(self, x):
        return x

    def inverse_log_det_jacobian(self, y):
        return -torch.log(y)


class Chain(Bijector):
    """Apply bijectors right-to-left: Chain([f, g]).forward(x) = f(g(x))."""

    def __init__(self, bijectors):
        self.bijectors = list(bijectors)

    def forward(self, x):
        for b in reversed(self.bijectors):
            x = b.forward(x)
        return x

    def inverse(self, y):
        for b in self.bijectors:
            y = b.inverse(y)
        return y

    def forward_log_det_jacobian(self, x):
        total = torch.zeros_like(x)
        for b in reversed(self.bijectors):
            total = total + b.forward_log_det_jacobian(x)
            x = b.forward(x)
        return total
