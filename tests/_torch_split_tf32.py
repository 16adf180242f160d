"""The split-TF32 arithmetic of the tensor-core kernels (csrc/split_tf32.cuh,
K5 in csrc/fused_expsum.cu and the wide K1/K2 in csrc/fused_poisson_wide.cu),
emulated on the CPU for tests/test_torch_expsum_split.py and
tests/test_torch_stats_split.py.

The kernels' products run on ``mma.sync.m16n8k8`` with TF32 operands (10
explicit mantissa bits) and float32 accumulators. Each float32 operand x
splits as hi = rna(x) and lo = rna(x - hi), rna rounding to 10 explicit
mantissa bits, to nearest with ties away from zero (cvt.rna.tf32.f32, or
the same bits in integer arithmetic in the wide kernels); each product of a
k-step of 8 is lo.hi + hi.lo + hi.hi, added to the float32 accumulator in
that order (the small terms first; lo.lo is dropped). ``tf32_rna``
emulates rna on the float32 bit pattern.
"""
import torch

KSTEP = 8       # latent dimensions (or rows, or columns) an mma k-step adds


def tf32_rna(x):
    """float32 -> the float32 value of cvt.rna.tf32.f32(x) (finite x)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def round_toward_zero(x):
    """float64 -> float32, rounded toward zero (finite x)."""
    f = x.to(torch.float32)
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def mma_steps(a, b, passes, partial=None, truncate=False, group=1):
    """sum_k a[..., :, k] b[..., k, :] over k-steps of KSTEP in a float32
    accumulator; per k-step the products of ``passes``: 3 (lo.hi, hi.lo,
    hi.hi, in that order) or 1 (hi.hi). ``partial``: the accumulator
    restarts from zero every ``partial`` k-steps, each partial added into
    a float32 sum (``group`` > 1: ``group`` partials added together first,
    then their sum). ``truncate``: the accumulator rounds toward zero."""
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    shape = a.shape[:-1] + b.shape[-1:]
    acc = total = grouped = torch.zeros(shape, dtype=torch.float32)
    for i, k0 in enumerate(range(0, a.shape[-1], KSTEP)):
        ka = (..., slice(k0, k0 + KSTEP))
        kb = (..., slice(k0, k0 + KSTEP), slice(None))
        terms = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))
        for x, y in terms[3 - passes:]:
            if truncate:
                acc = round_toward_zero(acc.double()
                                        + x[ka].double() @ y[kb].double())
            else:
                acc = acc + x[ka] @ y[kb]
        if partial and (i + 1) % partial == 0:
            grouped, acc = grouped + acc, torch.zeros(shape,
                                                      dtype=torch.float32)
            if (i + 1) % (partial * group) == 0:
                total, grouped = total + grouped, torch.zeros(
                    shape, dtype=torch.float32)
    return total + (grouped + acc)


def pad_to(x, dim, multiple):
    extra = -x.shape[dim] % multiple
    if not extra:
        return x
    shape = list(x.shape)
    shape[dim] = extra
    return torch.cat([x, torch.zeros(shape, dtype=x.dtype)], dim)


