"""Counter-based random numbers: the part of JAX's ``random`` module
(threefry2x32 with partitionable counters, JAX's default) that the bridge,
the runner and the bench harness use.

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words
(the ``key_data`` of a JAX key, see ``convert.prng_key_from_numpy``).
Every function is batched over the leading axes of its keys and returns
the bits JAX returns for each key, so the bridge's draws match the JAX
package's bit for bit:

  * ``key(seed)``            -> ``[seed >> 32, seed & 0xFFFFFFFF]``
  * ``fold_in(key, d)``      -> ``threefry2x32(key, (0, d))``
  * ``split(key, n)[i]``     -> ``threefry2x32(key, (0, i))`` (the
    partitionable counter: the high and low words of a 64-bit iota)
  * 32 random bits -> ``y0 ^ y1``, 64 bits -> ``(y0 << 32) | y1``, of
    ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))`` for element ``i`` (in
    row-major order) of a draw of shape ``S``; shape ``()`` is ``i = 0``
  * ``uniform``: the top mantissa bits under the exponent of 1.0, minus 1,
    scaled to ``[lo, hi)`` and floored at ``lo``
  * ``randint(key, S, lo, hi)`` (int32): two 32-bit draws of shape ``S``
    from ``split(key, 2)``, combined modulo ``hi - lo`` as JAX combines
    them (its bias and all).

``bits``, ``uniform`` and ``normal`` take a ``shape`` (default ``()``),
as ``randint`` does: the result has the keys' batch dims followed by
``shape``, each key drawing its own array.

uint32 arithmetic runs in int64 tensors masked to 32 bits, which every
device supports. Raw bits are exact. XLA fuses ``uniform``'s affine map
``u * (hi - lo) + lo`` into one multiply-add: in float32 the port rounds
that map once as well (through float64), and in float64 it is exact
wherever the map is (every range the bridge draws from with default
parameters: (0, 1), (-1, 1), (0.5, 1.5) and the normal's); elsewhere a
float64 draw may differ from XLA's by one ulp. ``normal``
(``sqrt(2) erfinv``) and ``exponential`` (``-log1p(-u)``) apply the device's own special functions to the exact
uniform, so they differ from XLA's by a few ulps (the tests bound them).
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher, 20 rounds, elementwise over
    broadcast int64 tensors holding uint32 words. Returns ``(y0, y1)``."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def key(seed: int, device: torch.device | str = "cuda") -> torch.Tensor:
    """The data of JAX's ``random.key(seed)``: a ``(2,)`` key from a 64-bit
    seed, on ``device`` (the card unless the caller passes another)."""
    seed = int(seed)
    if not -2**63 <= seed < 2**64:
        raise ValueError(f"seed {seed} does not fit in 64 bits")
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK], dtype=torch.int64,
                        device=device)


def _words(k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if k.shape[-1:] != (2,) or k.dtype != torch.int64:
        raise ValueError(f"a key is an int64 (..., 2) tensor, got "
                         f"{k.dtype} {tuple(k.shape)}")
    return k[..., 0], k[..., 1]


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """JAX's ``random.fold_in``: keys ``(..., 2)`` and integer data that
    broadcast; data is taken modulo 2**32 (JAX casts it to uint32)."""
    k0, k1 = _words(k)
    data = torch.as_tensor(data, device=k.device).to(torch.int64) & _MASK
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(data), data)
    return torch.stack((y0, y1), dim=-1)


def split(k: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's ``random.split(k, n)`` for keys ``(..., 2)``: ``(..., n, 2)``."""
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    return fold_in(k[..., None, :], i)


def bits(k: torch.Tensor, width: int, shape: tuple = ()) -> torch.Tensor:
    """Random bits of ``width`` (32 or 64) per element of ``shape`` per
    key, as int64 (64-bit draws wrap to negative where the top bit is
    set): ``(...) + shape``."""
    k0, k1 = _words(k)
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=k.device).reshape(shape)
    lead = k0.shape + (1,) * len(shape)
    y0, y1 = threefry2x32(k0.reshape(lead), k1.reshape(lead), i >> 32, i & _MASK)
    if width == 32:
        return y0 ^ y1
    if width == 64:
        return (y0 << 32) | y1
    raise ValueError(f"width must be 32 or 64, got {width}")


def uniform(k: torch.Tensor, dtype: torch.dtype = torch.float32,
            lo: float = 0.0, hi: float = 1.0, shape: tuple = ()) -> torch.Tensor:
    """JAX's ``random.uniform(k, shape, dtype, lo, hi)`` for each key."""
    lo_t = torch.tensor(lo, dtype=dtype, device=k.device)
    hi_t = torch.tensor(hi, dtype=dtype, device=k.device)
    if dtype == torch.float32:
        f = ((bits(k, 32, shape) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
        # XLA fuses u * (hi - lo) + lo into one multiply-add; in float64
        # the product is exact and the sum rounds once before float32
        u = (f.double() - 1.0) * (hi_t - lo_t).double() + lo_t.double()
        return torch.maximum(lo_t, u.float())
    if dtype == torch.float64:
        # the arithmetic shift's sign extension lands only in bits the
        # mantissa mask clears
        f = (((bits(k, 64, shape) >> 12) & ((1 << 52) - 1))
             | 0x3FF0000000000000).view(torch.float64)
        return torch.maximum(lo_t, (f - 1.0) * (hi_t - lo_t) + lo_t)
    raise TypeError(f"uniform draws float32 or float64, got {dtype}")


def normal(k: torch.Tensor, dtype: torch.dtype = torch.float32,
           shape: tuple = ()) -> torch.Tensor:
    """JAX's ``random.normal(k, shape, dtype)``: ``sqrt(2) erfinv(u)`` with
    u uniform on ``[nextafter(-1, 0), 1)``."""
    lo = torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                         torch.tensor(0.0, dtype=dtype)).item()
    u = uniform(k, dtype, lo, 1.0, shape)
    return torch.erfinv(u) * torch.tensor(math.sqrt(2.0), dtype=dtype,
                                          device=k.device)


def exponential(k: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """JAX's ``random.exponential(k, (), dtype)``: ``-log1p(-u)``."""
    return -torch.log1p(-uniform(k, dtype))


def randint(k: torch.Tensor, shape: tuple, lo: int, hi: int) -> torch.Tensor:
    """JAX's ``random.randint(k, shape, lo, hi, int32)`` for int32 bounds
    with ``lo < hi``: two 32-bit draws from ``split(k, 2)`` reduced modulo
    the span in wrapping uint32 arithmetic. Returns int32."""
    if not -2**31 <= lo < hi <= 2**31 - 1:
        raise ValueError(f"randint needs int32 bounds lo < hi, got [{lo}, {hi})")
    span = hi - lo
    k_hi, k_lo = split(k, 2).unbind(-2)
    mult = ((2**16 % span) ** 2 & _MASK) % span
    offset = ((bits(k_hi, 32, shape) % span) * mult & _MASK) + bits(k_lo, 32, shape) % span
    return ((offset & _MASK) % span + lo).to(torch.int32)
