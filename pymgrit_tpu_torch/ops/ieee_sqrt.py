"""The correctly rounded square root of the plain versions (IEEE 754's
``sqrt``, what numpy, XLA and CUDA's ``sqrt`` give).

Why ``torch.sqrt`` is not enough on the CPU: ATen's CPU ``sqrt`` kernel
hands float32 and float64 tensors to MKL's vector math library
(``vsSqrt`` / ``vdSqrt``, through ``aten/src/ATen/cpu/vml.h``), whatever
``ATEN_CPU_CAPABILITY`` says, and MKL picks its code path by the host's
processor.  On some hosts (an AMD EPYC with AVX-512, for one) that path is
accurate to about an ulp but not correctly rounded: on 10^5 random values
``torch.sqrt`` differed from ``np.sqrt`` in about 1.2 % of the float64
results and 15 % of the float32 ones, numpy being the correctly rounded
one, and ``vdSqrt`` called directly gave ``torch.sqrt``'s bits in every
VML accuracy mode.  On other hosts MKL's path is the processor's ``sqrt``
instruction and the two agree.  A plain version that takes ``torch.sqrt``
where the JAX package takes ``jnp.sqrt`` therefore agrees with JAX on one
host and not on another.  CUDA's ``sqrt`` is correctly rounded, so on a
CUDA tensor ``sqrt_rn`` is ``torch.sqrt``.

On a CPU tensor ``sqrt_rn`` corrects ``torch.sqrt``'s result r, taken to
be within an ulp of the root (MKL's accuracy), in one exact step: the
correctly rounded root is r or a neighbour of r, and which one follows
from the exact signs of x - m^2 at the midpoints m between r and its
neighbours.  With r^2 = p + q exactly (Dekker's product), d = +-(half the
gap to the neighbour) and m = r + d,

    x - m^2 = S - d^2,  S = (x - p) - q - 2 r d.

Every term of S is a multiple of U U' (U the ulp of r, U' the gap on d's
side), and d^2 = U'^2 / 4 is smaller than that, so x > m^2 exactly when S
> 0 (x = m^2 cannot happen).  x - p is exact (p is within a factor two of
x), and two of Knuth's TwoSum give S's sign exactly.  Values far from 1
are scaled by an even power of two first, so that no product under- or
overflows.  float32 takes the float64 root of its value, rounded to
float32: with 53 >= 2 * 24 + 2 bits that double rounding is innocuous
(Figueroa), so the result is the correctly rounded float32 root.

Every step is one elementwise torch operation (no fused op, no host
read), so ``sqrt_rn`` runs under ``torch.vmap`` as ``torch.sqrt`` does.
"""

from __future__ import annotations

import torch

_SPLIT = 134217729.0                 # 2**27 + 1: Veltkamp's split of a 53-bit significand
_TINY, _HUGE = 2.0 ** -960, 2.0 ** 960
_SCALE = 2.0 ** 1000                 # an even power of two: its root 2**500 is exact


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _root_above(x, p, q, r, d):
    """True where x > (r + d)^2 exactly (r^2 = p + q, d a power of two or
    its negative, half the gap between r and a neighbour)."""
    b1, b2 = _two_sum(-q, -2.0 * r * d)
    c1, c2 = _two_sum(x - p, b1)
    return c1 + (c2 + b2) > 0


def _sqrt_rn_f64(x):
    """Correctly rounded float64 root of a float64 CPU tensor."""
    ok = torch.isfinite(x) & (x > 0)
    xs = torch.where(ok, x, 1.0)
    small, big = xs < _TINY, xs > _HUGE
    xs = torch.where(small, xs * _SCALE, torch.where(big, xs / _SCALE, xs))
    r = torch.sqrt(xs)
    c = _SPLIT * r
    hi = c - (c - r)
    lo = r - hi
    p = r * r
    q = ((hi * hi - p) + 2.0 * hi * lo) + lo * lo
    inf = torch.full((), float("inf"), dtype=x.dtype)
    up, down = torch.nextafter(r, inf), torch.nextafter(r, torch.zeros_like(inf))
    r = torch.where(_root_above(xs, p, q, r, 0.5 * (up - r)), up,
                    torch.where(_root_above(xs, p, q, r, 0.5 * (down - r)), r, down))
    r = torch.where(small, r * 2.0 ** -500, torch.where(big, r * 2.0 ** 500, r))
    return torch.where(ok, r, torch.sqrt(x))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """IEEE 754's correctly rounded square root of every element of x
    (float32 or float64; ``torch.sqrt`` on any other dtype and on the
    card)."""
    if x.device.type != "cpu" or x.dtype not in (torch.float32, torch.float64):
        return torch.sqrt(x)
    if x.dtype == torch.float32:
        return _sqrt_rn_f64(x.to(torch.float64)).to(torch.float32)
    return _sqrt_rn_f64(x)
