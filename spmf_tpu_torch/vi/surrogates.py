"""Trainable mean-field surrogate posteriors (mirrors
spmf_tpu/vi/surrogates.py).

Parameters are plain dicts of tensors ({name: {"loc", "raw_scale"}} for
Normal surrogates, {name: {"raw_concentration", "raw_scale"}} for
InverseGamma ones), the same leaf names as the JAX pytree. Randomness comes
from an explicit ``torch.Generator``. Draw order within
``sample_and_log_prob`` follows the JAX key split: the regular Normal
block, the broadcast Normals, the regular InverseGamma block, then the
broadcast InverseGammas.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from spmf_tpu_torch import bijectors as tfb
from spmf_tpu_torch import distributions as tfd
from spmf_tpu_torch.config import canonical_device, canonical_dtype

__all__ = [
    "TrainableNormal",
    "TrainableInverseGamma",
    "TransformedSurrogate",
    "SurrogatePosterior",
    "build_trainable_normal_dist",
    "build_trainable_InverseGamma_dist",
    "build_surrogate_posterior",
]

_softplus = tfb.Softplus()


def _np_softplus_inverse(y):
    y = np.asarray(y, np.float64)
    return y + np.log(-np.expm1(-y))


def _sum_event(x, event_ndims):
    if event_ndims == 0:
        return x
    return torch.sum(x, dim=tuple(range(-event_ndims, 0)))


class _Trainable:
    def __init__(self, shape, event_ndims, dtype, device):
        self.dtype = canonical_dtype(dtype)
        self.device = canonical_device(device)
        self.shape = tuple(shape)
        self.event_ndims = (len(self.shape) if event_ndims is None
                            else int(event_ndims))

    def _tensor(self, a):
        return torch.as_tensor(np.array(a), dtype=self.dtype,
                               device=self.device)


class TrainableNormal(_Trainable):
    """Mean-field Normal with trainable loc and softplus-parameterized
    scale."""

    def __init__(self, loc, scale, event_ndims=None, dtype=None,
                 device=None):
        loc, scale = np.asarray(loc), np.asarray(scale)
        super().__init__(np.broadcast_shapes(loc.shape, scale.shape),
                         event_ndims, dtype, device)
        self._loc0 = np.broadcast_to(loc, self.shape)
        self._raw_scale0 = _np_softplus_inverse(
            np.broadcast_to(scale, self.shape))

    def init(self) -> Dict[str, torch.Tensor]:
        return {"loc": self._tensor(self._loc0),
                "raw_scale": self._tensor(self._raw_scale0)}

    def log_prob(self, params, x):
        d = tfd.Normal(params["loc"], _softplus.forward(params["raw_scale"]))
        return _sum_event(d.log_prob(x), self.event_ndims)


class TrainableInverseGamma(_Trainable):
    """Trainable InverseGamma surrogate (softplus-parameterized
    concentration and scale), for the horseshoe+ auxiliaries."""

    def __init__(self, concentration, scale, event_ndims=None, dtype=None,
                 device=None):
        conc, scale = np.asarray(concentration), np.asarray(scale)
        super().__init__(np.broadcast_shapes(conc.shape, scale.shape),
                         event_ndims, dtype, device)
        self._raw_conc0 = _np_softplus_inverse(
            np.broadcast_to(conc, self.shape))
        self._raw_scale0 = _np_softplus_inverse(
            np.broadcast_to(scale, self.shape))

    def init(self) -> Dict[str, torch.Tensor]:
        return {"raw_concentration": self._tensor(self._raw_conc0),
                "raw_scale": self._tensor(self._raw_scale0)}

    def log_prob(self, params, x):
        d = tfd.InverseGamma(_softplus.forward(params["raw_concentration"]),
                             _softplus.forward(params["raw_scale"]))
        return _sum_event(d.log_prob(x), self.event_ndims)


class TransformedSurrogate:
    """base surrogate pushed through a bijector: y = b(x), with
    log q(y) = log q_base(x) - fldj(x) accumulated in base space."""

    def __init__(self, base, bijector):
        self.base = base
        self.bijector = bijector or tfb.Identity()

    @property
    def event_ndims(self):
        return self.base.event_ndims

    @property
    def shape(self):
        return self.base.shape

    def init(self):
        return self.base.init()

    def log_prob(self, params, y):
        """log q(y) = log q_base(b^-1(y)) - fldj(b^-1(y))."""
        x = self.bijector.inverse(y)
        fldj = _sum_event(self.bijector.forward_log_det_jacobian(x),
                          self.base.event_ndims)
        return self.base.log_prob(params, x) - fldj


class SurrogatePosterior:
    """Named mean-field surrogate: a dict of independent
    TransformedSurrogates over Normal or InverseGamma bases.

    Base samples are drawn with ONE flattened draw for all Normal
    surrogates and ONE IG-block draw for all InverseGamma surrogates.
    ``gamma_sampler``: 'exact' (rejection sampling with implicit
    reparameterisation gradients), 'fast' (boosted Wilson–Hilferty from
    generator draws; both in spmf_tpu_torch.ops.gamma) or 'fused' (the
    fused IG sampler: the CUDA kernel for CUDA tensors, its Philox twin on
    the CPU). ``fused_normals`` (attribute, off by default): with 'fused',
    draw the Normal block through the fused Normal sampler too
    (ops.fused_normal).

    ``broadcast_names``: variables sampled ONCE per step and shared across
    the S ELBO samples (values without the sample axis; their log q counted
    in every sample). Marginally each (main_s, aux) pair is a draw from the
    full mean-field q, so the ELBO estimate stays unbiased; the S terms are
    correlated through the shared draw."""

    #: opt-in for the fused Normal sampler (see ``_fused_normals_ok``)
    fused_normals = False

    def __init__(self, surrogates: Dict[str, TransformedSurrogate],
                 gamma_sampler: str = "exact", broadcast_names=(),
                 mesh=None, feature_axes=None, feature_axis="fp"):
        if gamma_sampler not in ("exact", "fast", "fused"):
            raise ValueError(f"unknown gamma_sampler {gamma_sampler!r}")
        self.gamma_sampler = gamma_sampler
        #: the rank mesh and each variable's feature axis (the axis of
        #: ``surrogates[name].shape`` that carries D; None: replicated):
        #: with parameters that hold this rank's fp slice, see
        #: ``sample_and_log_prob``
        self.mesh = mesh
        self.feature_axes = dict(feature_axes or {})
        self.feature_axis = feature_axis
        self.broadcast_names = frozenset(broadcast_names)
        self.surrogates = dict(surrogates)
        self._normal_names = [n for n, s in self.surrogates.items()
                              if isinstance(s.base, TrainableNormal)]
        self._ig_names = [n for n, s in self.surrogates.items()
                          if isinstance(s.base, TrainableInverseGamma)]
        other = set(self.surrogates) - set(self._normal_names) \
            - set(self._ig_names)
        if other:
            raise TypeError(f"unsupported surrogate bases for {sorted(other)}")
        self._sizes = {n: int(np.prod(s.shape))
                       for n, s in self.surrogates.items()}
        dtypes = {s.base.dtype for s in self.surrogates.values()}
        self.dtype = dtypes.pop() if len(dtypes) == 1 else None
        devices = {s.base.device for s in self.surrogates.values()}
        self.device = devices.pop() if len(devices) == 1 else None
        self._normal_masks = {}    # see _normal_mask

    @property
    def names(self):
        return list(self.surrogates.keys())

    def init(self):
        return {k: s.init() for k, s in self.surrogates.items()}

    def log_prob(self, params, values):
        """log q of given values (constrained space), summed over the
        variables."""
        logq = 0.0
        for name, s in self.surrogates.items():
            logq = logq + s.log_prob(params[name], values[name])
        return logq

    def _fused_normals_ok(self, names, sample_shape):
        """The fused Normal sampler is an opt-in
        (``surrogate.fused_normals = True``), as in the JAX package, where a
        TPU measurement had it 4% behind XLA's fused sampling; its time on
        the card against the plain block is in PERF.md. It takes the
        'fused' sampler setting, float32, a 0/1-dim sample shape and
        Softplus or Identity bijectors."""
        return (self.fused_normals and self.gamma_sampler == "fused"
                and len(sample_shape) <= 1 and self.dtype == torch.float32
                and all(isinstance(self.surrogates[n].bijector,
                                   (tfb.Softplus, tfb.Identity))
                        for n in names))

    def _sample_normals_fused(self, names, params, generator, sample_shape):
        """One fused-sampler call for all Normal surrogates: draws ->
        loc + softplus(raw_scale) * eps -> bijector -> logq partial sums."""
        from spmf_tpu_torch.ops.fused_normal import fused_normal_sample_logq

        loc_flat = torch.cat([params[n]["loc"].reshape(-1) for n in names])
        rs_flat = torch.cat([params[n]["raw_scale"].reshape(-1)
                             for n in names])
        mask_flat = self._normal_mask(names)
        S = sample_shape[0] if sample_shape else 1
        # drawn on the device: the kernel reads the seed there, no host sync
        seed = torch.randint(0, 2**31 - 1, (1,), generator=generator,
                             dtype=torch.int32, device=self.device)
        y, logq = fused_normal_sample_logq(loc_flat, rs_flat, mask_flat,
                                           seed, S)
        return self._split_block(names, y, sample_shape), \
            (logq if sample_shape else logq[0])

    def _normal_mask(self, names):
        """The fused Normal sampler's (total,) float32 bijector mask of
        ``names`` (1.0 Softplus, 0.0 Identity): a constant, made once per
        (names, device) and kept."""
        key = (tuple(names), str(self.device))
        if key not in self._normal_masks:
            self._normal_masks[key] = torch.cat([
                torch.full((self._sizes[n],),
                           1.0 if isinstance(self.surrogates[n].bijector,
                                             tfb.Softplus) else 0.0,
                           dtype=torch.float32, device=self.device)
                for n in names])
        return self._normal_masks[key]

    def _split_block(self, names, y, sample_shape):
        """Cut a sampler's (S, total) output back into the named
        variables."""
        values = {}
        off = 0
        for n in names:
            s = self.surrogates[n]
            sz = self._sizes[n]
            block = y[:, off:off + sz]
            off += sz
            values[n] = (block.reshape(sample_shape + s.shape) if sample_shape
                         else block[0].reshape(s.shape))
        return values

    def _sample_normals(self, names, params, generator, sample_shape,
                        logq_params=None, antithetic=False, eps=None):
        if (logq_params is None and eps is None and not antithetic
                and self._fused_normals_ok(names, sample_shape)):
            return self._sample_normals_fused(names, params, generator,
                                              sample_shape)
        values, logq = {}, 0.0
        total = sum(self._sizes[n] for n in names)
        if eps is None:
            if antithetic:
                # mirrored pairs eps_{s+S/2} = -eps_s; 'stratified' also
                # couples the pairs with a randomly shifted lattice of base
                # uniforms, eps_p = ndtri(frac(u0 + p/H)): each keeps the
                # exact N(0, 1) marginal
                S = sample_shape[0]
                if antithetic == "stratified":
                    from spmf_tpu_torch.ops.gamma import lattice_uniform

                    eps_h = torch.special.ndtri(lattice_uniform(
                        generator, S // 2, (total,), self.dtype,
                        self.device))
                else:
                    eps_h = torch.randn((S // 2, total), generator=generator,
                                        dtype=self.dtype, device=self.device)
                eps = torch.cat([eps_h, -eps_h], dim=0)
            else:
                eps = torch.randn(sample_shape + (total,),
                                  generator=generator, dtype=self.dtype,
                                  device=self.device)
        else:
            eps = torch.as_tensor(
                eps if isinstance(eps, torch.Tensor) else np.array(eps),
                dtype=self.dtype, device=self.device)
        # eps-form logq: at x = loc + scale*eps the mean-field normal density
        # is exactly -0.5 eps^2 - log(scale) - 0.5 log(2 pi) per coordinate,
        # gradients included (needs the live parameters as the density's and
        # fully summed events)
        eps_logq = logq_params is None and all(
            self.surrogates[n].event_ndims == len(self.surrogates[n].shape)
            for n in names)
        scale_logsum = 0.0
        off = 0
        for n in names:
            s = self.surrogates[n]
            p = params[n]
            sz = self._sizes[n]
            e = eps[..., off:off + sz].reshape(sample_shape + s.shape)
            off += sz
            scale = _softplus.forward(p["raw_scale"])
            x = p["loc"] + scale * e
            if eps_logq:
                scale_logsum = scale_logsum + torch.sum(torch.log(scale))
                if not isinstance(s.bijector, tfb.Identity):
                    logq = logq - _sum_event(
                        s.bijector.forward_log_det_jacobian(x), s.event_ndims)
            else:
                # STL (logq_params): the density's parameters come from the
                # stopped tree while the sample path stays live, evaluated
                # here in pre-bijector space (a constrained-space inverse
                # would clamp softplus-floored samples)
                loc_q, scale_q = p["loc"], scale
                if logq_params is not None:
                    loc_q = logq_params[n]["loc"]
                    scale_q = _softplus.forward(logq_params[n]["raw_scale"])
                logq = logq + _sum_event(
                    tfd.Normal(loc_q, scale_q).log_prob(x), s.event_ndims
                ) - _sum_event(s.bijector.forward_log_det_jacobian(x),
                               s.event_ndims)
            values[n] = s.bijector.forward(x)
        if eps_logq:
            logq = logq + (-0.5 * torch.sum(eps * eps, dim=-1) - scale_logsum
                           - 0.5 * total * math.log(2.0 * math.pi))
        return values, logq

    def _fused_igs_ok(self, names, sample_shape):
        """The fused IG sampler takes softplus bijectors, float32 and a
        0/1-dim sample shape (the JAX dispatch rules)."""
        return (self.gamma_sampler == "fused" and len(sample_shape) <= 1
                and self.dtype == torch.float32
                and all(isinstance(self.surrogates[n].bijector, tfb.Softplus)
                        for n in names))

    # ------------------------------------------------------------ meshes
    def _fp_size(self):
        if self.mesh is None or self.feature_axis not in self.mesh.axis_names:
            return 1
        return int(self.mesh.shape[self.feature_axis])

    def _split_axis(self, name):
        """The axis of ``name`` that fp splits, or None."""
        nsh = self._fp_size()
        ax = self.feature_axes.get(name)
        if nsh <= 1 or ax is None:
            return None
        dim = self.surrogates[name].shape[ax]
        return ax if dim > 1 and dim % nsh == 0 else None

    def _is_slice(self, name, t):
        ax = self._split_axis(name)
        return ax is not None and t.shape[ax] != self.surrogates[name].shape[ax]

    def _holds_slices(self, params):
        """Whether ``params`` holds this rank's fp slices (rather than the
        full variables)."""
        if self._fp_size() <= 1:
            return False
        return any(self._is_slice(n, t) for n in self.surrogates
                   if n in params for t in params[n].values())

    def _gathered(self, names, params):
        """``params`` of ``names`` with every fp slice gathered to the full
        variable: one flat buffer and one differentiable gather over the fp
        line (its backward keeps this rank's block of the summed
        cotangent)."""
        split = [(n, k) for n in names for k, t in params[n].items()
                 if self._is_slice(n, t)]
        out = {n: dict(params[n]) for n in names}
        if not split:
            return out
        mesh, fp = self.mesh, self._fp_size()
        moved = [params[n][k].movedim(self._split_axis(n), 0)
                 for n, k in split]
        flat = torch.cat([m.reshape(-1) for m in moved])
        full = mesh.gather(flat, 0, (self.feature_axis,), grad=True)
        full = full.reshape(fp, -1)
        off = 0
        for (n, k), m in zip(split, moved):
            blk = full[:, off:off + m.numel()].reshape((fp,) + m.shape)
            off += m.numel()
            out[n][k] = blk.reshape((fp * m.shape[0],) + m.shape[1:]) \
                .movedim(0, self._split_axis(n))
        return out

    def _local_values(self, values):
        """This rank's columns of the fp-split variables among ``values``
        (with any leading sample axes)."""
        out = dict(values)
        for n, v in values.items():
            ax = self._split_axis(n)
            if ax is None:
                continue
            shape = self.surrogates[n].shape
            dim = ax - len(shape)
            if v.shape[dim] == shape[ax]:      # not a slice yet
                c0, c1 = self.mesh.feature_slice(shape[ax])
                out[n] = v.narrow(dim, c0, c1 - c0)
        return out

    def _fused_igs_sharded_ok(self, names, sample_shape):
        """The fused IG sampler on an fp mesh: the fused rules hold and
        every fp-carrying variable's feature dim splits evenly (replicated
        variables take the plain kernel, the same on every rank)."""
        if self._fp_size() <= 1 or not self._fused_igs_ok(names,
                                                          sample_shape):
            return False
        for n in names:
            ax = self.feature_axes.get(n)
            if ax is None:
                continue
            dim = self.surrogates[n].shape[ax]
            if dim > 1 and dim % self._fp_size():
                return False
        return True

    def _sample_igs_fused_sharded(self, names, params, generator,
                                  sample_shape, antithetic=False):
        """The fused IG block on an fp mesh (spmf_tpu's
        ``_sample_igs_fused_sharded``): replicated variables through one
        plain K3 call, the same seed on every rank; the fp-split variables
        through one K3 call on this rank's slices with seed ``base +
        fp_index`` (the base drawn from the generator, the sum kept on the
        device), and their log q partials summed over the fp line."""
        sharded = [n for n in names if self._split_axis(n) is not None]
        repl = [n for n in names if n not in sharded]
        values, logq = {}, 0.0
        if repl:
            values, logq = self._sample_igs_fused(repl, params, generator,
                                                  sample_shape, antithetic)
        if not sharded:
            return values, logq
        local = self._local_values({n: params[n]["raw_concentration"]
                                    for n in sharded})
        local_b = self._local_values({n: params[n]["raw_scale"]
                                      for n in sharded})
        a_flat = torch.cat([_softplus.forward(local[n]).reshape(-1)
                            for n in sharded])
        b_flat = torch.cat([_softplus.forward(local_b[n]).reshape(-1)
                            for n in sharded])
        S = sample_shape[0] if sample_shape else 1
        seed = torch.randint(0, 2**31 - 1, (1,), generator=generator,
                             dtype=torch.int32, device=self.device) \
            + self.mesh.fp_index
        y, lq = self._ig_kernel(a_flat, b_flat, seed, S,
                                antithetic=antithetic)
        off = 0
        for n in sharded:
            shape = tuple(local[n].shape)
            sz = local[n].numel()
            block = y[:, off:off + sz]
            off += sz
            values[n] = (block.reshape(sample_shape + shape) if sample_shape
                         else block[0].reshape(shape))
        lq = self.mesh.all_sum(lq, (self.feature_axis,))
        return values, logq + (lq if sample_shape else lq[0])

    def _ig_kernel(self, a_flat, b_flat, seed, S, antithetic=False):
        from spmf_tpu_torch.ops.fused_ig import fused_ig_sample_logq

        return fused_ig_sample_logq(a_flat, b_flat, seed, S, antithetic)

    def _sample_igs_fused(self, names, params, generator, sample_shape,
                          antithetic=False):
        """One fused-sampler call for the whole IG block: draws -> boosted
        WH gamma -> IG transform -> softplus -> logq partial sums."""
        a_flat = torch.cat([
            _softplus.forward(params[n]["raw_concentration"]).reshape(-1)
            for n in names])
        b_flat = torch.cat([
            _softplus.forward(params[n]["raw_scale"]).reshape(-1)
            for n in names])
        S = sample_shape[0] if sample_shape else 1
        # drawn on the device: the kernel reads the seed there, no host sync
        seed = torch.randint(0, 2**31 - 1, (1,), generator=generator,
                             dtype=torch.int32, device=self.device)
        y, logq = self._ig_kernel(a_flat, b_flat, seed, S,
                                  antithetic=antithetic)
        return self._split_block(names, y, sample_shape), \
            (logq if sample_shape else logq[0])

    def _sample_igs(self, names, params, generator, sample_shape,
                    logq_params=None, antithetic=False, draws=None):
        from spmf_tpu_torch.ops.gamma import sample_gamma

        if (logq_params is None and draws is None
                and self._holds_slices(params)
                and self._fused_igs_sharded_ok(names, sample_shape)):
            return self._sample_igs_fused_sharded(
                names, params, generator, sample_shape, antithetic=antithetic)
        if (logq_params is None and draws is None
                and self._fused_igs_ok(names, sample_shape)):
            return self._sample_igs_fused(names, params, generator,
                                          sample_shape, antithetic=antithetic)
        values, logq = {}, 0.0
        conc_flat = torch.cat([
            _softplus.forward(params[n]["raw_concentration"]).reshape(-1)
            for n in names])
        conc_b = conc_flat.expand(sample_shape + conc_flat.shape)
        # 'fused' degrades to the same WH sampler where the kernel's rules
        # do not hold (float64, multi-dim sample shapes, injected draws, STL)
        method = ("fast" if self.gamma_sampler == "fused" or draws is not None
                  else self.gamma_sampler)
        g = sample_gamma(generator, conc_b, method, antithetic=antithetic,
                         draws=draws)
        off = 0
        for n in names:
            s = self.surrogates[n]
            sz = self._sizes[n]
            a = _softplus.forward(params[n]["raw_concentration"])
            b = _softplus.forward(params[n]["raw_scale"])
            gs = g[..., off:off + sz].reshape(sample_shape + s.shape)
            off += sz
            x = b / gs
            if logq_params is not None:  # STL: the stopped parameters
                a = _softplus.forward(logq_params[n]["raw_concentration"])
                b = _softplus.forward(logq_params[n]["raw_scale"])
            logq = logq + _sum_event(
                tfd.InverseGamma(a, b).log_prob(x), s.event_ndims
            ) - _sum_event(s.bijector.forward_log_det_jacobian(x),
                           s.event_ndims)
            values[n] = s.bijector.forward(x)
        return values, logq

    def sample_and_log_prob(self, params, generator, sample_shape=(),
                            antithetic=False, draws=None,
                            apply_broadcast=True, logq_params=None):
        """Joint reparameterized sample and log q. ``antithetic``: mirror
        the base draws across the (1-d, even) sample axis; 'stratified'
        also lattice-couples the pairs (``ops.gamma.lattice_uniform``, and
        the stratified stream of the fused IG sampler).

        ``apply_broadcast``: draw the ``broadcast_names`` once, at sample
        shape (), as four blocks in the JAX order (regular Normals,
        broadcast Normals, regular IGs, broadcast IGs); False draws every
        variable per sample. ``logq_params``: a second parameter tree the
        DENSITY is evaluated with while the sample path uses ``params``
        (the STL estimator passes the parameters detached); it forces the
        plain samplers, whose densities stay in pre-bijector space.

        On a mesh with an fp axis, ``params`` may hold this rank's slice of
        the fp-split variables (``parallel.shard_params_feature_dim``): the
        values of those variables are then this rank's columns and log q is
        the whole sum, on every rank. Every block but the fused IG one is
        drawn at full width from the gathered parameters, exactly as one
        process draws it (all ranks consume the generator in lockstep); the
        fused IG block runs K3 on the local slices
        (``_sample_igs_fused_sharded``).

        ``draws`` (tests): a dict replacing the generator's draws —
        ``normal_eps`` (sample_shape + (total normal,)), ``ig_eps`` /
        ``ig_u`` (sample_shape + (total IG,), and (8,) + that) for the
        'fast' IG sampler, and ``bc_normal_eps`` / ``bc_ig_eps`` /
        ``bc_ig_u`` for the broadcast blocks (no sample axis)."""
        sample_shape = tuple(sample_shape)
        if antithetic and (len(sample_shape) != 1 or sample_shape[0] % 2):
            raise ValueError("antithetic sampling needs a 1-d even sample "
                             f"shape, got {sample_shape}")
        draws = draws or {}
        bset = (self.broadcast_names if apply_broadcast and sample_shape
                else frozenset())
        normals = [n for n in self._normal_names if n not in bset]
        bc_normals = [n for n in self._normal_names if n in bset]
        igs = [n for n in self._ig_names if n not in bset]
        bc_igs = [n for n in self._ig_names if n in bset]

        def ig_draws(prefix):
            if prefix + "ig_eps" in draws:
                return draws[prefix + "ig_eps"], draws[prefix + "ig_u"]
            return None

        local = self._holds_slices(params)
        values, logq = {}, 0.0
        for names, fn, shape, anti, inject in (
                (normals, self._sample_normals, sample_shape, antithetic,
                 draws.get("normal_eps")),
                (bc_normals, self._sample_normals, (), False,
                 draws.get("bc_normal_eps")),
                (igs, self._sample_igs, sample_shape, antithetic,
                 ig_draws("")),
                (bc_igs, self._sample_igs, (), False, ig_draws("bc_"))):
            if not names:
                continue
            if not local:
                v, lp = fn(names, params, generator, shape, logq_params,
                           anti, inject)
            elif (fn == self._sample_igs and logq_params is None
                  and inject is None
                  and self._fused_igs_sharded_ok(names, shape)):
                v, lp = fn(names, params, generator, shape, None, anti)
            else:
                # drawn at full width exactly as one process draws, from
                # the gathered parameters; the fp-split values keep this
                # rank's columns
                v, lp = fn(names, self._gathered(names, params), generator,
                           shape, None if logq_params is None else
                           self._gathered(names, logq_params), anti, inject)
                v = self._local_values(v)
            values.update(v)
            logq = logq + lp
        logq = torch.as_tensor(logq, dtype=self.dtype, device=self.device)
        return values, torch.broadcast_to(logq, sample_shape)

    def sample(self, params, generator, sample_shape=()):
        """Joint reparameterized sample: ``sample_and_log_prob`` without
        its log q (what WAIC draws with)."""
        return self.sample_and_log_prob(params, generator, sample_shape)[0]

    @torch.no_grad()
    def mean(self, params, generator=None, num_samples=250, chunk=10):
        """Calibrated expectations: the sample mean of each constrained
        variable, drawn in chunks of ``chunk`` samples."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(42)
        chunk = min(chunk, num_samples)
        n_chunks = max(num_samples // chunk, 1)
        out = {n: torch.zeros(s.shape, dtype=s.base.dtype,
                              device=s.base.device)
               for n, s in self.surrogates.items()}
        for _ in range(n_chunks):
            # broadcast off: calibration means need independent draws
            values, _ = self.sample_and_log_prob(params, generator, (chunk,),
                                                 apply_broadcast=False)
            for n, v in values.items():
                out[n] = out[n] + torch.mean(v, dim=0) / n_chunks
        return out


def build_trainable_normal_dist(loc, scale, ndims=None, dtype=None,
                                strategy=None, device=None):
    """API-parity helper (``strategy`` accepted and ignored)."""
    del strategy
    return TrainableNormal(loc, scale, event_ndims=ndims, dtype=dtype,
                           device=device)


def build_trainable_InverseGamma_dist(concentration, scale, ndims=None,
                                      dtype=None, strategy=None,
                                      device=None):
    del strategy
    return TrainableInverseGamma(concentration, scale, event_ndims=ndims,
                                 dtype=dtype, device=device)


def build_surrogate_posterior(joint_prior, bijectors, dtype=None,
                              strategy=None, init_loc=None, init_scale=None):
    """A mean-field surrogate for any named joint prior: per variable, a
    TrainableNormal in unconstrained space pushed through its bijector
    (Identity where ``bijectors`` names none), loc -3 (0 under Identity)
    and scale 1e-3, with the per-name ``init_loc`` / ``init_scale``
    overrides (scalars or arrays) on top. Shapes, the device and (with no
    ``dtype``) the dtype come from one draw of the prior; ``strategy`` is
    accepted and ignored."""
    del strategy
    init_loc = init_loc or {}
    init_scale = init_scale or {}
    # the root nodes are distribution objects and hold the prior's device
    device = next(node.device for node in joint_prior.model.values()
                  if hasattr(node, "log_prob"))
    probe = joint_prior.sample(torch.Generator(device=device).manual_seed(0))
    surrogates = {}
    for name, val in probe.items():
        b = (bijectors.get(name, tfb.Identity())
             if isinstance(bijectors, dict) else tfb.Identity())
        shape = tuple(val.shape)
        dt = canonical_dtype(dtype) if dtype is not None else val.dtype
        np_dt = np.float64 if dt == torch.float64 else np.float32
        loc = np.full(shape, 0.0 if isinstance(b, tfb.Identity) else -3.0,
                      np_dt)
        if name in init_loc:
            loc = np.broadcast_to(np.asarray(init_loc[name], np_dt), shape)
        scale = np.broadcast_to(
            np.asarray(init_scale.get(name, 1e-3), np_dt), shape)
        surrogates[name] = TransformedSurrogate(
            TrainableNormal(loc, scale, event_ndims=len(shape), dtype=dt,
                            device=val.device), b)
    return SurrogatePosterior(surrogates)
