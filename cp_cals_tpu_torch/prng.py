"""JAX's threefry-2x32 PRNG in PyTorch, bit for bit.

The counterpart of what the JAX package takes from ``jax.random``
(``PRNGKey``, ``fold_in``, ``split``, ``uniform``, ``normal``) with
``jax_threefry_partitionable`` on, its default: random bits are the hash of
each element's row-major index, so any slice of an array can be generated
alone and agree with the whole. A key is a ``[..., 2]`` int64 tensor
holding the two uint32 words of JAX's raw key; every word is held in int64
and masked to 32 bits after each add and rotate (PyTorch's uint32 takes
few ops, and ``>>`` on int64 is arithmetic). Leading key dims batch: a
``[*K, 2]`` key gives ``[*K, *shape]`` draws, one set per key.

Integers and ``uniform`` equal ``jax.random``'s bits. ``normal`` is
``sqrt(2) * erfinv(u)`` as in JAX, with XLA's ErfInv polynomials (Giles,
"Approximating the erfinv function"; ``torch.erfinv`` is another
approximation, up to 61 ulps from XLA's in float32). Its ``log1p`` is
PyTorch's: within 2 ulps of JAX in float32; in float64 XLA's ``log1p``
rounds ``1 - u^2`` first and reads up to 128 ulps off, which moves the
draw by up to 21 ulps (``tests/test_torch_prng.py``).
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _as_words(a, device=None) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.int64, device=device) & MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds, a key injection after every 4)
    of the counter pairs (x1, x2) under the key (k1, k2); all int64 words,
    broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & MASK
    b = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def prng_key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words (seed >> 32, seed & 0xFFFFFFFF)
    of a 64-bit seed; a tensor of seeds gives one key per seed."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device)
    return torch.stack([(s >> 32) & MASK, s & MASK], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter pair (0, data) under
    ``key``; ``data`` (an int or an int tensor) broadcasts against the
    key's leading dims."""
    d = _as_words(data, key.device)
    a, b = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([a, b], dim=-1)


def _counts(shape, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The (hi, lo) words of each element's row-major index (JAX's
    ``iota_2x32_shape``)."""
    n = math.prod(shape)
    if n > 2**62:
        raise ValueError(f"{n} draws: more than this generator counts")
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & MASK


def _hash_shape(key: torch.Tensor, shape) -> tuple[torch.Tensor, torch.Tensor]:
    shape = tuple(int(s) for s in shape)
    hi, lo = _counts(shape, key.device)
    expand = (slice(None),) * (key.ndim - 1) + (None,) * len(shape)
    return threefry2x32(key[..., 0][expand], key[..., 1][expand], hi, lo)


def split(key: torch.Tensor, num=2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): ``num`` (an int or a shape) new
    keys, the hash of each index."""
    shape = (num,) if isinstance(num, int) else tuple(num)
    a, b = _hash_shape(key, shape)
    return torch.stack([a, b], dim=-1)


def random_bits(key: torch.Tensor, bit_width: int, shape) -> torch.Tensor:
    """``jax.random.bits`` at 32 bits (``bits1 ^ bits2``, int64 holding the
    uint32) or 64 bits (``bits1 << 32 | bits2``, int64 holding the uint64's
    bit pattern)."""
    a, b = _hash_shape(key, shape)
    if bit_width == 32:
        return a ^ b
    if bit_width == 64:
        return (a << 32) | b
    raise ValueError(f"bit_width={bit_width}: 32 or 64 expected")


def uniform(key: torch.Tensor, shape, dtype=torch.float32, minval=0.0, maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform``: the mantissa bits of [1, 2) from the top of
    the random bits, minus one, scaled to [minval, maxval), no lower than
    minval."""
    if dtype == torch.float32:
        bits = random_bits(key, 32, shape)
        one = (bits >> 9) | 0x3F800000  # below 2^31: exact in int32
        floats = one.to(torch.int32).view(torch.float32) - 1.0
    elif dtype == torch.float64:
        bits = random_bits(key, 64, shape)
        # a logical shift by 12: the arithmetic shift's sign bits masked off
        one = ((bits >> 12) & ((1 << 52) - 1)) | 0x3FF0000000000000
        floats = one.view(torch.float64) - 1.0
    else:
        raise ValueError(f"dtype {dtype}: float32 or float64 expected")
    lo = torch.tensor(minval, dtype=dtype, device=key.device)
    hi = torch.tensor(maxval, dtype=dtype, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


# XLA's ErfInv coefficients, highest power first: float32 for w < 5 and
# w >= 5; float64 for w < 6.25, w < 16 and w >= 16 (w = -log1p(-u^2)).
_ERFINV32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
     -0.00125372503, -0.00417768164, 0.246640727, 1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
     -0.0076224613, 0.00943887047, 1.00167406, 2.83297682),
)
_ERFINV64 = (
    (-3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
     1.115787767802518096e-17, -1.333171662854620906e-16, 2.0972767875968561637e-17,
     6.6376381343583238325e-15, -4.0545662729752068639e-14, -8.1519341976054721522e-14,
     2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09, -2.9070369957882005086e-08,
     4.2347877827932403518e-07, -1.3654692000834678645e-06, -1.3882523362786468719e-05,
     0.0001867342080340571352, -0.00074070253416626697512, -0.0060336708714301490533,
     0.24015818242558961693, 1.6536545626831027356),
    (2.2137376921775787049e-09, 9.0756561938885390979e-08, -2.7517406297064545428e-07,
     1.8239629214389227755e-08, 1.5027403968909827627e-06, -4.013867526981545969e-06,
     2.9234449089955446044e-06, 1.2475304481671778723e-05, -4.7318229009055733981e-05,
     6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313, 0.0024914420961078508066,
     -0.0037512085075692412107, 0.005370914553590063617, 1.0052589676941592334,
     3.0838856104922207635),
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
     -3.7894654401267369937e-09, 7.6157012080783393804e-09, -1.4960026627149240478e-08,
     2.9147953450901080826e-08, -6.7711997758452339498e-08, 2.2900482228026654717e-07,
     -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347, -0.00013871931833623122026,
     1.0103004648645343977, 4.8499064014085844221),
)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's ErfInv: Horner steps over the coefficients of w's range, in
    XLA's order (module docstring), then ``p * x``; +-inf at +-1."""
    w = -torch.log1p(-x * x)

    def c(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    if x.dtype == torch.float32:
        small, big = _ERFINV32
        lt = w < 5.0
        w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
        p = torch.where(lt, c(small[0]), c(big[0]))
        for a, b in zip(small[1:], big[1:]):
            p = torch.where(lt, c(a), c(b)) + p * w
    else:
        a6, a16, rest = _ERFINV64
        lt6, lt16 = w < 6.25, w < 16.0

        def coeff(i):
            v = c(a6[i])
            if i < len(a16):
                v = torch.where(lt6, v, c(a16[i]))
            if i < len(rest):
                v = torch.where(lt16, v, c(rest[i]))
            return v

        w = torch.where(lt6, w - 3.125, torch.sqrt(w) - torch.where(lt16, c(3.25), c(5.0)))
        p = coeff(0)
        for i in range(1, len(rest)):
            p = coeff(i) + p * w
        for i in range(len(rest), len(a16)):
            p = torch.where(lt16, coeff(i) + p * w, p)
        for i in range(len(a16), len(a6)):
            p = torch.where(lt6, coeff(i) + p * w, p)
    return torch.where(torch.abs(x) == 1, x * torch.finfo(x.dtype).max, p * x)


def normal(key: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal``: ``sqrt(2) * erfinv(u)`` for u uniform on
    (-1, 1); within a few ulps of JAX (module docstring)."""
    lo = torch.nextafter(torch.tensor(-1.0, dtype=dtype), torch.tensor(0.0, dtype=dtype)).item()
    u = uniform(key, shape, dtype, lo, 1.0)
    return torch.tensor(math.sqrt(2), dtype=dtype, device=key.device) * erfinv(u)
