"""Unrolled 6x6 SPD solve (Cholesky), straight-line code.

``jnp.linalg.solve`` lowers small dense solves through generic LU
machinery (or a solver library call) — a measurable fixed cost inside the tracker's
LM ``while_loop``. The damped normal equations A = JtWJ + lambda*diag(JtWJ)
are symmetric positive (semi-)definite, so an unrolled Cholesky
forward/backward substitution compiles to a single short fused kernel.

Replaces the role of Eigen's ``colPivHouseholderQr`` 6x6 solve in the
reference (``lm_optimizer.cpp:151``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def solve_spd6(A: jax.Array, b: jax.Array, eps: float = 1e-12) -> jax.Array:
    """Solve A x = b for 6x6 SPD A via fully unrolled Cholesky.

    Singular/indefinite inputs produce non-finite outputs, exactly like the
    library solve; callers already guard with isfinite.
    """
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        Ljj = jnp.sqrt(jnp.maximum(s, eps))
        L[j][j] = Ljj
        inv = 1.0 / Ljj
        for i in range(j + 1, n):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    # Forward substitution: L y = b
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # Backward substitution: L^T x = y
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x)
