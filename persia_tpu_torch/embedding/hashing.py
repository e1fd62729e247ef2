"""Sign hashing, shard routing, hash-stack, index-prefix math and the
seeded-by-sign row init (counterpart of ``persia_tpu/embedding/hashing.py``).

Everything is wrapping u64 splitmix64 in vectorized numpy. The numbers are
the reference's to the bit: the same sign routes to the same replica, and a
row initialized here for a (sign, seed) equals the row ``persia_tpu``
initializes for it.
"""

from __future__ import annotations

import math

import numpy as np

_C1 = np.uint64(0x9E3779B97F4A7C15)
_C2 = np.uint64(0xBF58476D1CE4E5B9)
_C3 = np.uint64(0x94D049BB133111EB)

# Per-round xor seeds for the hash stack (arbitrary odd constants).
_ROUND_SEEDS = np.array(
    [(0x243F6A8885A308D3 + 0x9E3779B97F4A7C15 * r) & 0xFFFFFFFFFFFFFFFF for r in range(16)],
    dtype=np.uint64,
)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer over a u64 array (wrapping arithmetic)."""
    x = x.astype(np.uint64, copy=True)
    x += _C1
    x ^= x >> np.uint64(30)
    x *= _C2
    x ^= x >> np.uint64(27)
    x *= _C3
    x ^= x >> np.uint64(31)
    return x


def sign_to_shard(signs: np.ndarray, num_shards: int) -> np.ndarray:
    """Route each sign to a parameter-server replica (hash modulo)."""
    return (splitmix64(signs) % np.uint64(num_shards)).astype(np.int64)


def hash_stack(signs: np.ndarray, rounds: int, embedding_size: int) -> np.ndarray:
    """Expand each sign into ``rounds`` compressed table keys: round ``r``
    maps into ``[r * embedding_size, (r+1) * embedding_size)``. Returns shape
    ``(len(signs), rounds)``."""
    out = np.empty((len(signs), rounds), dtype=np.uint64)
    for r in range(rounds):
        h = splitmix64(signs ^ _ROUND_SEEDS[r])
        out[:, r] = h % np.uint64(embedding_size) + np.uint64(r * embedding_size)
    return out


def add_index_prefix(signs: np.ndarray, prefix: int, prefix_bit: int) -> np.ndarray:
    """Partition one global key space across slots by OR-ing a per-slot
    prefix into the top ``prefix_bit`` bits."""
    if prefix == 0 or prefix_bit == 0:
        return signs.astype(np.uint64, copy=False)
    mask = np.uint64((1 << (64 - prefix_bit)) - 1)
    return (signs.astype(np.uint64) & mask) | np.uint64(prefix)


def seed_for_sign(sign: int, base_seed: int = 0) -> int:
    """Deterministic per-sign RNG seed for reproducible embedding init."""
    arr = np.array([np.uint64(sign) ^ np.uint64(base_seed)], dtype=np.uint64)
    return int(splitmix64(arr)[0])


def uniform_init_for_signs(
    signs: np.ndarray, seed: int, n: int, lo: float, hi: float
) -> np.ndarray:
    """Counter-mode splitmix64 rows: ``u_i = splitmix64(splitmix64(sign ^
    seed) + i)`` mapped to [lo, hi) via the top 53 bits; (M, n) f32."""
    bases = splitmix64(signs.astype(np.uint64) ^ np.uint64(seed))  # seed_for_sign
    states = splitmix64(bases[:, None] + np.arange(n, dtype=np.uint64)[None, :])
    u = (states >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))
    return (lo + u * (hi - lo)).astype(np.float32)


# Non-uniform kinds: each element i of a row gets its own splitmix64
# substream, and every transcendental goes through scalar libm (math.*), so
# the rows match the reference's bit for bit.

_M64 = (1 << 64) - 1
_TO_UNIT = 1.0 / 9007199254740992.0  # 2^-53
_TWO_PI = 6.283185307179586


def _sm64(x: int) -> int:
    """Scalar splitmix64 (wrapping u64), identical to the vectorized one."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


class _SubStream:
    """The j-th uniform of element ``i``: to_unit(sm64(sm64(base + i) + 1 + j))."""

    def __init__(self, base: int, i: int):
        self._b = _sm64((base + i) & _M64)
        self._j = 0

    def next(self) -> float:
        u = (_sm64((self._b + 1 + self._j) & _M64) >> 11) * _TO_UNIT
        self._j += 1
        return u


def _normal_from(st: _SubStream, mean: float, std: float) -> float:
    u1 = max(st.next(), _TO_UNIT)
    u2 = st.next()
    return mean + std * (math.sqrt(-2.0 * math.log(u1)) * math.cos(_TWO_PI * u2))


def _poisson_from(st: _SubStream, lam: float) -> float:
    if lam <= 0.0:
        return 0.0
    big_l = math.exp(-lam)
    k, p = 0, 1.0
    while k < 4096:  # the reference's hard cap
        k += 1
        p *= st.next()
        if not p > big_l:
            break
    return float(k - 1)


def _gamma_from(st: _SubStream, shape: float, scale: float) -> float:
    """Marsaglia-Tsang; for shape<1 boost via u^(1/shape) drawn FIRST."""
    if shape <= 0.0:
        return 0.0
    boost, k = 1.0, shape
    if k < 1.0:
        boost = math.pow(max(st.next(), _TO_UNIT), 1.0 / k)
        k += 1.0
    d = k - 1.0 / 3.0
    c = 1.0 / (3.0 * math.sqrt(d))
    for _ in range(1024):  # the reference's cap
        x = _normal_from(st, 0.0, 1.0)
        v = 1.0 + c * x
        if v <= 0.0:
            continue
        v = v * v * v
        u = st.next()
        if u < 1.0 - 0.0331 * x * x * x * x:
            return boost * d * v * scale
        if math.log(max(u, _TO_UNIT)) < 0.5 * x * x + d * (1.0 - v + math.log(v)):
            return boost * d * v * scale
    return boost * d * scale  # pathological-params fallback


def _init_row_scalar(sign: int, seed: int, n: int, method) -> np.ndarray:
    base = seed_for_sign(sign, seed)
    out = np.empty(n, dtype=np.float32)
    for i in range(n):
        st = _SubStream(base, i)
        if method.kind == "normal":
            out[i] = _normal_from(st, method.p0, method.p1)
        elif method.kind == "poisson":
            out[i] = _poisson_from(st, method.p0)
        elif method.kind == "gamma":
            out[i] = _gamma_from(st, method.p0, method.p1)
        else:
            raise ValueError(f"unknown init kind: {method.kind!r}")
    return out


def init_for_signs(signs: np.ndarray, seed: int, n: int, method) -> np.ndarray:
    """(M, n) f32 init rows for ``signs`` under a
    ``config.InitializationMethod``; uniform kinds are vectorized."""
    signs = np.asarray(signs, dtype=np.uint64).ravel()
    if method.kind == "uniform":
        return uniform_init_for_signs(signs, seed, n, method.p0, method.p1)
    if method.kind == "inverse_sqrt":
        b = 1.0 / float(np.sqrt(n))
        return uniform_init_for_signs(signs, seed, n, -b, b)
    if not len(signs):
        return np.empty((0, n), dtype=np.float32)
    return np.stack([_init_row_scalar(int(s), seed, n, method) for s in signs])
