"""Hadamard matrices, the reference transform and the offline pipeline's
random rotations (counterpart of ``mquant_tpu/transform/hadamard.py``).

Orders: Sylvester doubling for powers of two, Paley I/II over prime and
prime-power fields, Kronecker products; orders 156 and 172 fall back to a
seeded random orthogonal block, exactly as in the JAX package. The
transform: :func:`fwht` (the butterfly), :func:`hadamard_transform` (n =
K·2^p) and its dense matrix :func:`transform_matrix`, the references that
the two-matmul kernels are held against. The random rotations draw from an
explicit ``torch.Generator`` (other values than JAX's ``jax.random``).
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Tuple

import numpy as np
import torch

# largest supported non-pow2 factor first (148: Qwen2-VL-7B 18944 = 148·128)
SUPPORTED_K = [924, 172, 156, 148, 140, 108, 60, 52, 40, 36, 28, 20, 12, 1]

_RANDOM_ORTHO_K = {156, 172}
_RANDOM_ORTHO_SEED = 20250816


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _gf_elements(p: int, m: int):
    """Elements, addition and multiplication tables of GF(p^m) (tiny fields)."""
    if m == 1:
        elems = list(range(p))
        mul = [[(a * b) % p for b in elems] for a in elems]
        add = [[(a + b) % p for b in elems] for a in elems]
        return elems, add, mul

    def poly_mul_mod(a, b, modpoly):
        res = [0] * (2 * m)
        for i, ai in enumerate(a):
            if ai:
                for j, bj in enumerate(b):
                    res[i + j] = (res[i + j] + ai * bj) % p
        for d in range(2 * m - 1, m - 1, -1):
            c = res[d]
            if c:
                res[d] = 0
                for k in range(m):
                    res[d - m + k] = (res[d - m + k] - c * modpoly[k]) % p
        return tuple(res[:m])

    def poly_mul(a, b):
        res = [0] * (len(a) + len(b) - 1)
        for i, ai in enumerate(a):
            for j, bj in enumerate(b):
                res[i + j] = (res[i + j] + ai * bj) % p
        return res

    def find_irreducible():
        monics = {d: [list(c) + [1] for c in itertools.product(range(p), repeat=d)]
                  for d in range(1, m)}
        for c in itertools.product(range(p), repeat=m):
            cand = list(c) + [1]
            reducible = any(poly_mul(f, g) == cand
                            for d in range(1, m // 2 + 1)
                            for f in monics[d] for g in monics[m - d])
            if not reducible:
                return cand
        raise RuntimeError("no irreducible polynomial found")

    modpoly = find_irreducible()
    elems = [tuple(c) for c in itertools.product(range(p), repeat=m)]
    idx = {e: i for i, e in enumerate(elems)}
    add = [[idx[tuple((a[k] + b[k]) % p for k in range(m))] for b in elems]
           for a in elems]
    mul = [[idx[poly_mul_mod(a, b, modpoly)] for b in elems] for a in elems]
    return list(range(len(elems))), add, mul


def _factor_prime_power(q: int):
    """(p, m) if q = p^m for prime p, else None."""
    if q < 2:
        return None
    p = None
    d = 2
    while d * d <= q:
        if q % d == 0:
            p = d
            break
        d += 1
    if p is None:
        return q, 1
    n, m = q, 0
    while n % p == 0:
        n //= p
        m += 1
    return (p, m) if n == 1 else None


def _paley_qr_char(q: int) -> np.ndarray:
    """Q[i, j] = chi(a_i − a_j) over GF(q), chi the quadratic character."""
    p, m = _factor_prime_power(q)
    elems, add, mul = _gf_elements(p, m)
    qn = len(elems)
    squares = {mul[a][a] for a in elems if a != 0}
    neg = [None] * qn
    for a in elems:
        for b in elems:
            if add[a][b] == 0:
                neg[a] = b
    chi = np.array([0.0 if a == 0 else (1.0 if a in squares else -1.0)
                    for a in elems])
    Qm = np.zeros((qn, qn))
    for i in elems:
        for j in elems:
            Qm[i, j] = chi[add[i][neg[j]]]
    return Qm


def _paley_I(q: int) -> np.ndarray:
    """Order q+1 for prime power q ≡ 3 (mod 4)."""
    Qm = _paley_qr_char(q)
    n = q + 1
    H = np.ones((n, n))
    H[1:, 1:] = Qm + np.eye(q)
    H[1:, 0] = -1.0
    return H


def _paley_II(q: int) -> np.ndarray:
    """Order 2(q+1) for prime power q ≡ 1 (mod 4)."""
    Qm = _paley_qr_char(q)
    n = q + 1
    S = np.zeros((n, n))
    S[0, 1:] = 1.0
    S[1:, 0] = 1.0
    S[1:, 1:] = Qm
    A = np.array([[1.0, 1.0], [1.0, -1.0]])
    B = np.array([[1.0, -1.0], [-1.0, -1.0]])
    H = np.kron(S, A)
    for i in range(n):
        H[2 * i: 2 * i + 2, 2 * i: 2 * i + 2] = B
    return H


@functools.lru_cache(maxsize=None)
def hadamard_matrix(n: int) -> np.ndarray:
    """An exact {±1} Hadamard matrix of order n, or ValueError."""
    if n == 1:
        return np.ones((1, 1))
    if n == 2:
        return np.array([[1.0, 1.0], [1.0, -1.0]])
    if n % 2 == 0 and is_pow2(n):
        return np.kron(np.array([[1.0, 1.0], [1.0, -1.0]]),
                       hadamard_matrix(n // 2))
    if n % 4 != 0:
        raise ValueError(f"no Hadamard matrix of order {n}")
    q = n - 1
    if _factor_prime_power(q) is not None and q % 4 == 3:
        return _paley_I(q)
    q = n // 2 - 1
    if _factor_prime_power(q) is not None and q % 4 == 1:
        return _paley_II(q)
    try:
        return np.kron(np.array([[1.0, 1.0], [1.0, -1.0]]),
                       hadamard_matrix(n // 2))
    except ValueError:
        pass
    raise ValueError(f"no Hadamard construction implemented for order {n}")


@functools.lru_cache(maxsize=None)
def _block_K(K: int) -> np.ndarray:
    """Orthonormal K×K block: Hadamard/√K, or seeded random orthogonal."""
    if K == 1:
        return np.ones((1, 1))
    if K in _RANDOM_ORTHO_K:
        rng = np.random.default_rng(_RANDOM_ORTHO_SEED + K)
        qmat, r = np.linalg.qr(rng.standard_normal((K, K)))
        return qmat * np.sign(np.diag(r))[None, :]
    return hadamard_matrix(K) / math.sqrt(K)


def get_hadK(n: int) -> Tuple[np.ndarray, int]:
    """Largest supported K with n/K a power of two, and its orthonormal
    K×K block."""
    for K in SUPPORTED_K:
        if K == 1:
            continue
        if n % K == 0 and is_pow2(n // K):
            return _block_K(K), K
    if not is_pow2(n):
        raise ValueError(f"dimension {n} is not K*2^p for supported K "
                         f"{SUPPORTED_K}")
    return _block_K(1), 1


def auto_pad_size(n: int) -> int:
    """Smallest m ≥ n of the form K·2^p with K supported."""
    for K in SUPPORTED_K:
        if n % K == 0 and is_pow2(n // K):
            return n
    best = math.inf
    for K in SUPPORTED_K:
        p2 = 2 ** math.ceil(math.log2(math.ceil(n / K)))
        best = min(best, K * p2)
    return int(best)


# ---------------------------------------------------------------------------
# the transform
# ---------------------------------------------------------------------------


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized fast Walsh–Hadamard transform along the last axis (pow2
    n): the iterative butterfly, one add/sub pass per doubling, in x's
    dtype."""
    n = x.shape[-1]
    if not is_pow2(n):
        raise ValueError(f"fwht needs a power-of-two dim, got {n}")
    y = x.reshape(-1, n)
    h = 1
    while h < n:
        y = y.reshape(-1, n // (2 * h), 2, h)
        a, b = y[..., 0, :], y[..., 1, :]
        y = torch.stack([a + b, a - b], dim=-2)
        h *= 2
    return y.reshape(x.shape)


def hadamard_transform(x: torch.Tensor, hadK=None, K=None) -> torch.Tensor:
    """Orthonormal Hadamard-style transform along the last axis of size
    n = K·2^p: view (…, K, n/K) → butterfly over n/K → K-block product →
    orthonormal scaling, in x's dtype (the JAX function's op order)."""
    n = x.shape[-1]
    if hadK is None or K is None:
        hadK, K = get_hadK(n)
    hadK = torch.as_tensor(hadK).to(device=x.device, dtype=x.dtype)
    scale = torch.tensor(1.0 / math.sqrt(n // K), dtype=x.dtype,
                         device=x.device)  # hadK is already orthonormal
    if K == 1:
        return fwht(x) * scale
    xr = fwht(x.reshape(*x.shape[:-1], K, n // K)) * scale
    return torch.einsum("kl,...lm->...km", hadK, xr).reshape(x.shape)


def transform_matrix(n: int, dtype=np.float64) -> np.ndarray:
    """Dense n×n matrix H of :func:`hadamard_transform` (orthogonal): the
    online transform of x equals x @ H.T."""
    hadK, K = get_hadK(n)
    m = n // K
    Hm = hadamard_matrix(m) / math.sqrt(m)
    return np.kron(hadK, Hm).astype(dtype)


# ---------------------------------------------------------------------------
# random rotations
# ---------------------------------------------------------------------------


def random_hadamard_matrix(n: int, gen: torch.Generator, device="cuda"
                           ) -> torch.Tensor:
    """Randomized Hadamard H · diag(±1) in float64 on ``device``
    (orthogonal); the signs are drawn from ``gen`` on its own device."""
    signs = torch.randint(0, 2, (n,), generator=gen, device=gen.device)
    signs = (signs * 2 - 1).to(device=device, dtype=torch.float64)
    H = torch.from_numpy(transform_matrix(n)).to(device)
    return H * signs[None, :]


def random_orthogonal_matrix(n: int, gen: torch.Generator, device="cuda"
                             ) -> torch.Tensor:
    """QR of an f32 normal draw in float64, column signs fixed by diag(R)
    (orthogonal)."""
    a = torch.randn((n, n), generator=gen, device=gen.device,
                    dtype=torch.float32).to(device=device, dtype=torch.float64)
    qmat, r = torch.linalg.qr(a)
    return qmat * torch.sign(torch.diagonal(r))[None, :]


def get_orthogonal_matrix(n: int, mode: str, gen: torch.Generator,
                          device="cuda") -> torch.Tensor:
    """mode ∈ {"hadamard", "random"}."""
    if mode == "hadamard":
        return random_hadamard_matrix(n, gen, device)
    if mode == "random":
        return random_orthogonal_matrix(n, gen, device)
    raise ValueError(f"unknown rotation mode {mode!r}")
