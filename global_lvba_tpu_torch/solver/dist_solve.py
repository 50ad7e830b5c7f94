"""Block-Jacobi preconditioned CG for the damped reduced system (port of
global_lvba_tpu.solver.dist_solve, single device: the closed-form block
inverses, the shared PCG loop and solve_damped_cg).

The loop has the reference's form: exactly `max_iters` trips, the state
frozen by torch.where once ||r||/||b|| < tol, and no read to the host.
On a CUDA tensor solve_damped_cg runs its preamble and trips as one CUDA
graph (the counterpart of the reference's single compiled fori_loop),
captured once per solve shape and replayed per solve; on the CPU the same
trips run eagerly.
"""

from __future__ import annotations

import time
from collections import OrderedDict

import torch


def _inv3_batched(A: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched 3x3 blocks via the adjugate, each
    block normalized by its max |entry| first (tiny damped blocks would
    otherwise underflow the f32 cofactors); inv(s·A') = inv(A')/s."""
    s = torch.amax(A.abs(), dim=(-2, -1), keepdim=True)
    s = torch.where(s == 0, torch.ones_like(s), s)
    A = A / s
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / torch.where(det == 0, torch.full_like(det, 1e-30), det)
    r0 = torch.stack([c00, a02 * a21 - a01 * a22, a01 * a12 - a02 * a11], -1)
    r1 = torch.stack([c01, a00 * a22 - a02 * a20, a02 * a10 - a00 * a12], -1)
    r2 = torch.stack([c02, a01 * a20 - a00 * a21, a00 * a11 - a01 * a10], -1)
    return torch.stack([r0, r1, r2], -2) * (inv_det[..., None, None] / s)


def inv_blocks_6x6(D: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched SPD 6x6 blocks by the 2x2-of-3x3
    Schur complement."""
    A = D[..., :3, :3]
    B = D[..., :3, 3:]
    C = D[..., 3:, :3]
    E = D[..., 3:, 3:]
    Ai = _inv3_batched(A)
    CAi = C @ Ai
    S = E - CAi @ B
    Si = _inv3_batched(S)
    AiB = Ai @ B
    TL = Ai + AiB @ (Si @ CAi)
    TR = -(AiB @ Si)
    BL = -(Si @ CAi)
    top = torch.cat([TL, TR], dim=-1)
    bot = torch.cat([BL, Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _block_jacobi_inv_damped(A: torch.Tensor, damp: torch.Tensor,
                             bsize: int) -> torch.Tensor:
    """Inverses of the bsize x bsize diagonal blocks of A + diag(damp);
    the damping is added to the extracted blocks, never to A."""
    n = A.shape[0]
    W = n // bsize
    idx = torch.arange(W, device=A.device)
    diag = A.reshape(W, bsize, W, bsize)[idx, :, idx, :]        # (W, b, b)
    eye = torch.eye(bsize, dtype=A.dtype, device=A.device)
    diag = diag + damp.reshape(W, bsize)[:, :, None] * eye
    diag = diag + 1e-30 * eye
    if bsize == 6:
        return inv_blocks_6x6(diag)
    # inv_ex: no error check, so no read to the host (the blocks are
    # damped SPD, as in the reference's jnp.linalg.inv)
    return torch.linalg.inv_ex(diag)[0]


def _pcg(matvec, precond, b: torch.Tensor, max_iters: int, tol: float):
    """Preconditioned CG from x = 0: exactly `max_iters` trips; once
    ||r||²/||b||² < tol², x, r, p and rz freeze (the reference's
    done-masked fori_loop, global_lvba_tpu/solver/dist_solve.py:117-152).
    Nothing is read to the host.  x, r and p are the rows of one (3, n)
    state, so a trip's freeze is one torch.where: in a CUDA graph the
    count of a trip's small launches (18 beside the matvec's two) sets
    its time."""
    z = precond(b)
    S = torch.stack([torch.zeros_like(b), b, z])      # x, r, p
    rz = torch.dot(b, z)
    b2 = torch.clamp(torch.dot(b, b), min=torch.finfo(b.dtype).tiny)
    done = torch.zeros((), dtype=torch.bool, device=b.device)
    for _ in range(max_iters):
        x, r, p = S
        Ap = matvec(p)
        denom = torch.dot(p, Ap)
        alpha = rz / torch.where(denom == 0, 1.0, denom)
        S_n = torch.empty_like(S)
        torch.addcmul(x, alpha, p, out=S_n[0])
        torch.addcmul(r, alpha, Ap, value=-1.0, out=S_n[1])
        z_n = precond(S_n[1])
        rz_n = torch.dot(S_n[1], z_n)
        beta = rz_n / torch.where(rz == 0, 1.0, rz)
        torch.addcmul(z_n, beta, p, out=S_n[2])
        conv = torch.dot(S_n[1], S_n[1]) / b2 < tol * tol
        S = torch.where(done, S, S_n)
        rz = torch.where(done, rz, rz_n)
        done = done | conv
    return S[0]


def _damped_cg(H: torch.Tensor, g: torch.Tensor, u: torch.Tensor,
               bsize: int, max_iters: int, tol: float) -> torch.Tensor:
    d = torch.diagonal(H)
    # same epsilon as the LU solve (solver/lm.py): pins exactly-zero rows
    eps = 1e-12 * (1.0 + torch.max(d.abs()))
    damp = u * d + eps

    def matvec(x):
        return torch.addmv(damp * x, H, x)

    Minv = _block_jacobi_inv_damped(H, damp, bsize)

    def precond(r):
        W = r.shape[0] // bsize
        return torch.bmm(Minv, r.reshape(W, bsize, 1)).reshape(-1)

    return _pcg(matvec, precond, -g, max_iters, tol)


class DampedCGGraph:
    """solve_damped_cg for one shape on one card as a captured CUDA graph.
    The graph reads the static buffers H, g and u and writes x; a solve
    copies its operands in, replays, and returns a copy of x.  Capture
    runs one trip first on a side stream (cuBLAS' handle and workspace),
    then captures the preamble and all `max_iters` trips; a capture that
    fails raises."""

    def __init__(self, n: int, dtype: torch.dtype, device: torch.device,
                 bsize: int, max_iters: int, tol: float):
        t0 = time.perf_counter()
        with torch.cuda.device(device):
            self.H = torch.zeros((n, n), dtype=dtype, device=device)
            self.g = torch.zeros(n, dtype=dtype, device=device)
            self.u = torch.zeros((), dtype=dtype, device=device)
            cur = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                _damped_cg(self.H, self.g, self.u, bsize, 1, tol)
            cur.wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.x = _damped_cg(self.H, self.g, self.u, bsize, max_iters,
                                    tol)
        self.capture_s = time.perf_counter() - t0

    def __call__(self, H, g, u):
        self.H.copy_(H)
        self.g.copy_(g)
        self.u.copy_(u)
        self.graph.replay()
        return self.x.clone()


# the captured solves, by (n, dtype, device, bsize, max_iters, tol); the
# oldest is dropped past GRAPH_CACHE_SIZE (each holds an (n, n) buffer)
GRAPH_CACHE_SIZE = 4
_GRAPHS: OrderedDict = OrderedDict()


def cg_graph(n: int, dtype: torch.dtype, device: torch.device,
             bsize: int = 6, max_iters: int = 256,
             tol: float = 1e-10) -> DampedCGGraph:
    """The captured damped CG solve of this shape, capturing it on the
    first call."""
    key = (n, dtype, torch.device(device), bsize, max_iters, tol)
    graph = _GRAPHS.get(key)
    if graph is None:
        graph = DampedCGGraph(n, dtype, key[2], bsize, max_iters, tol)
        _GRAPHS[key] = graph
        while len(_GRAPHS) > GRAPH_CACHE_SIZE:
            _GRAPHS.popitem(last=False)
    _GRAPHS.move_to_end(key)
    return graph


def solve_damped_cg(
    H: torch.Tensor,
    g: torch.Tensor,
    u: torch.Tensor,
    bsize: int = 6,
    max_iters: int = 256,
    tol: float = 1e-10,
) -> torch.Tensor:
    """Solve (H + u * diag(H)) dx = -g by block-Jacobi preconditioned CG:
    `max_iters` done-masked trips, no read to the host.  On a CUDA tensor
    one replay of the captured graph (cg_graph); on the CPU the trips run
    eagerly."""
    if H.device.type == "cuda":
        return cg_graph(H.shape[0], H.dtype, H.device, bsize, max_iters,
                        tol)(H, g, u)
    return _damped_cg(H, g, u, bsize, max_iters, tol)
