"""Kernels K1 ``interval_affine``, K2 ``theta_chain``, K5 ``sine_solve2d``,
K6 ``sine_affine2d``, K20 ``sine_solve1d`` and the double-double K23
``dd_interval_affine`` and K24 ``dd_theta_chain`` (CUDA C++), each beside
its plain PyTorch version.

Dispatch: a tensor on the CPU goes to the plain version; a CUDA tensor
launches the kernel from ``csrc/`` (built on first use by ``_build``) or
raises.  Each wrapper checks device, dtype, shape and strides first and
counts its launches in ``<wrapper>.launches``.

All rows are addressed with strides, so the solver passes strided views of
its level tubes and the kernels write straight into them.  In every
operand the last axis must be contiguous.  K1 and K2 see a state as a row of
N spectral coefficients; K5 and K6 see a physical state as an (r, c)
interior, or the full (r + 2, c + 2) field with its Dirichlet ring, whose
rows may have any stride; K20 sees a 1D physical state (one point of a
BDF pair state) as a row of n interior values.
"""

from __future__ import annotations

import array
import ctypes
import functools

import torch

from pymgrit_tpu_torch.ops import _build

_FLOATS = (torch.float32, torch.float64)


def _require(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check_operands(name: str, tensors: dict) -> None:
    """Common checks against the first tensor's dtype and device."""
    _check_facts(name, [fact(t) for t in tensors.values()], list(tensors).__getitem__)


def fact(t):
    """What the wrappers check of a tensor: (dtype, device, shape, strides)
    (hashable, so that a wrapper can cache its checks by it)."""
    return t.dtype, t.device, t.shape, t.stride()


def _check_facts(name: str, facts, key) -> None:
    """The common checks on ``fact``s, against the first one's dtype and
    device.  Each message (and its key) is formatted only when its check
    fails: this runs on every launch."""
    dtype, device = facts[0][0], facts[0][1]
    if dtype not in _FLOATS:
        _require(False, name, f"dtype {dtype} is not float32/float64")
    for k, (dt, dev, shape, stride) in enumerate(facts):
        if dt != dtype:
            _require(False, name, f"{key(k)} has dtype {dt}, expected {dtype}")
        if dev != device:
            _require(False, name, f"{key(k)} is on {dev}, expected {device}")
        if shape[-1] > 1 and stride[-1] != 1:
            _require(False, name, f"{key(k)} must be contiguous in its last axis")
    if device.type not in ("cpu", "cuda"):
        _require(False, name, f"unsupported device {device}")


def _launcher(name: str, dtype: torch.dtype):
    return getattr(_build.library(), f"{name}_{'f64' if dtype == torch.float64 else 'f32'}")


# ---------------------------------------------------------------------------
# K1 interval_affine
# ---------------------------------------------------------------------------


def interval_affine_plain(x, A, G, out, r0=0, seed_out=None):
    """out[j, r] = A[r0 + r] * x[j] + G[r0 + r]; seed_out[j] = x[j]."""
    R = out.shape[1]
    out.copy_(x[:, None] * A[None, r0:r0 + R] + G[None, r0:r0 + R])
    if seed_out is not None:
        seed_out.copy_(x)
    return out


def _contiguous(shape, stride) -> bool:
    """True iff a tensor of this shape and these strides is contiguous."""
    inner = 1
    for n, st in zip(reversed(shape), reversed(stride)):
        if n > 1 and st != inner:
            return False
        inner *= n
    return True


@functools.lru_cache(maxsize=1024)
def _interval_checked(facts, r0):
    """Every check of a K1 call, on the ``fact``s of x, A, G, out (and
    seed_out) and r0, cached by them (K1 runs at every level-0 C-step and
    F-sweep: the checks' host time is paid once a shape); returns (on the
    CPU, the launcher's size and stride arguments, the launcher)."""
    name = "interval_affine"
    _check_facts(name, facts, ("x", "A", "G", "out", "seed_out").__getitem__)
    (dtype, device, (J, N), xs), (_, _, ash, ast), (_, _, gsh, gst), (_, _, osh, ost) = facts[:4]
    if not (len(ash) == 2 and ash == gsh and ash[1] == N and _contiguous(ash, ast)
            and _contiguous(gsh, gst)):
        _require(False, name, "A and G must be contiguous (T, N) tables")
    if not (len(osh) == 3 and osh[0] == J and osh[2] == N):
        _require(False, name, f"out has shape {tuple(osh)}, expected ({J}, R, {N})")
    R = osh[1]
    if not (0 <= r0 and r0 + R <= ash[0]):
        _require(False, name, f"rows {r0}..{r0 + R - 1} outside the {ash[0]}-row table")
    if len(facts) == 5 and tuple(facts[4][2]) != (J, N):
        _require(False, name, "seed_out must have the shape of x")
    if device.type == "cpu":
        return True, None, None
    sizes = (xs[0], r0, R, J, N, ost[0], ost[1], facts[4][3][0] if len(facts) == 5 else 0)
    return False, sizes, _launcher("pm_interval_affine", dtype)


def interval_affine(x, A, G, out, r0=0, seed_out=None):
    """Closed-form interval relaxation into ``out``.

    x: (J, N) seeds; A, G: (T, N) contiguous tables; out: (J, R, N) view
    with any interval and row strides (row-major, interval-major or the
    tube's own block view), rows r0..r0+R-1 of the tables; seed_out:
    optional (J, N) view that receives a copy of x.  Returns out.
    """
    ops = (x, A, G, out) if seed_out is None else (x, A, G, out, seed_out)
    on_cpu, sizes, fn = _interval_checked(tuple(map(fact, ops)), r0)
    if on_cpu:
        return interval_affine_plain(x, A, G, out, r0, seed_out)
    x_sj, r0, R, J, N, out_sj, out_sr, seed_sj = sizes
    if J == 0 or N == 0:
        return out
    status = fn(x.data_ptr(), x_sj, A.data_ptr(), G.data_ptr(), r0, R, J, N, out.data_ptr(),
                out_sj, out_sr, seed_out.data_ptr() if seed_out is not None else None, seed_sj,
                _build.stream(x.device.index))
    _build.check(status, "interval_affine")
    interval_affine.launches += 1
    return out


interval_affine.launches = 0


# ---------------------------------------------------------------------------
# K2 theta_chain
# ---------------------------------------------------------------------------


def theta_chain_plain(x0, out, dt, lam, lift, rhs1, rhs0, theta, g=None):
    """J chains of L spectral theta-steps (expression order of
    ``Heat2D._step_spectral``), each step plus g[:, k] when given."""
    x = x0
    for k in range(out.shape[1]):
        d = dt[k][:, None]
        shift = d * theta
        if theta == 1.0:
            b = x + d * rhs1[k] + shift * lift
        else:
            b = (x - shift * (x * lam)) + (shift * 2.0) * lift \
                + d * (theta * rhs1[k] + (1 - theta) * rhs0[k])
        x = b / (1.0 + shift * lam)
        if g is not None:
            x = g[:, k] + x
        out[:, k] = x
    return out


def theta_chain(x0, out, dt, lam, lift, rhs1, rhs0, theta, g=None):
    """Sequential spectral theta-steps of J chains, every step written.

    x0: (J, N) seeds; out: (J, L, N) view; g: optional (J, L, N) view added
    after each step; dt: (L, J) contiguous step sizes; lam, lift: (N,)
    eigenvalues and lifted boundary data; rhs1, rhs0: (L, J, N) views of the
    rhs at the step's end and start (strides 0 for a time-independent rhs;
    rhs0 is read only when theta != 1).  out must not overlap x0 or g.
    Returns out.
    """
    name = "theta_chain"
    ops = dict(x0=x0, out=out, dt=dt, lam=lam, lift=lift, rhs1=rhs1, rhs0=rhs0)
    if g is not None:
        ops["g"] = g
    _check_operands(name, ops)
    J, N = x0.shape
    L = out.shape[1]
    _require(out.dim() == 3 and out.shape[0] == J and out.shape[2] == N, name,
             f"out has shape {tuple(out.shape)}, expected ({J}, L, {N})")
    _require(g is None or g.shape == out.shape, name, "g must have the shape of out")
    _require(tuple(dt.shape) == (L, J) and dt.is_contiguous(), name,
             f"dt must be a contiguous ({L}, {J}) tensor")
    _require(tuple(lam.shape) == (N,) and tuple(lift.shape) == (N,), name,
             "lam and lift must have shape (N,)")
    _require(rhs1.shape == out.shape[1:2] + (J, N) and rhs0.shape == rhs1.shape
             and rhs0.stride() == rhs1.stride(), name,
             "rhs1 and rhs0 must be (L, J, N) views with equal strides")
    _require(float(theta) > 0.0, name, "theta must be > 0 (BE or CN)")
    if x0.device.type == "cpu":
        return theta_chain_plain(x0, out, dt, lam, lift, rhs1, rhs0, theta, g)
    if J == 0 or L == 0 or N == 0:
        return out
    fn = _launcher("pm_theta_chain", x0.dtype)
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    status = fn(x0.data_ptr(), x0.stride(0), out.data_ptr(), out.stride(0), out.stride(1),
                g.data_ptr() if g is not None else None,
                g.stride(0) if g is not None else 0, g.stride(1) if g is not None else 0,
                dt.data_ptr(), lam.data_ptr(), lift.data_ptr(), rhs1.data_ptr(),
                rhs0.data_ptr(), rhs1.stride(0), rhs1.stride(1), float(theta),
                J, L, N, stream)
    _build.check(status, name)
    theta_chain.launches += 1
    return out


theta_chain.launches = 0


# ---------------------------------------------------------------------------
# K5 sine_solve2d, K6 sine_affine2d: physical-basis two-sided sine products
# ---------------------------------------------------------------------------

ONE_TILE = 128       # largest side of the one-tile cores (csrc/sine2d.cuh, sine2d_dmma.cuh)
TILED_CHUNK = 512    # states the tiled paths stage at a time


def tiled_workspace(states: int, r: int, c: int, like: torch.Tensor):
    """(workspace, chunk) of the tiled path of K5, K6 and K10: two buffers
    of a chunk of (r, c) states; (None, 0) where both sides fit the
    one-tile core."""
    if max(r, c) <= ONE_TILE:
        return None, 0
    chunk = min(states, TILED_CHUNK)
    return torch.empty((2, chunk, r, c), dtype=like.dtype, device=like.device), chunk


def _with_ring(interior, out, ring):
    """out <- the full states: ring template outside, interior inside."""
    full = ring.expand(out.shape).clone()
    full[..., 1:-1, 1:-1] = interior
    return full


def sine_solve2d_plain(b, out, Sx, Sy, lam=None, shift=None, ring=None, g=None):
    """out = [g +] Sx ((Sx b Sy) / (1 + shift * lam)) Sy, or Sx b Sy without
    lam; with ring, out is the full state around that interior."""
    x = torch.matmul(torch.matmul(Sx, b), Sy)
    if lam is not None:
        s = shift.view(-1, 1, 1) if isinstance(shift, torch.Tensor) else shift
        x = x / (1.0 + s * lam)
        x = torch.matmul(torch.matmul(Sx, x), Sy)
    if ring is not None:
        x = _with_ring(x, out, ring)
    out.copy_(x if g is None else g + x)
    return out


def _state_facts(name, key, shape, B, P, Q):
    if tuple(shape) != (B, P, Q):
        _require(False, name, f"{key} has shape {tuple(shape)}, expected ({B}, {P}, {Q})")


def _state_view(name, key, t, B, P, Q):
    _state_facts(name, key, t.shape, B, P, Q)


# sine_solve2d's operands in the order of its argument array's pointer
# slots 1-8 (csrc/sine_solve2d.cu ``launch``)
_SOLVE_KEYS = ("b", "out", "Sx", "Sy", "lam", "ring", "g", "shift")


@functools.lru_cache(maxsize=1024)
def _solve_checked(facts, present, has_shift):
    """Every check of a K5 call, on the ``fact``s of the operands given
    (``present``: which of ``_SOLVE_KEYS``) and whether a shift is, cached
    by them (K5 runs at every physical step: 820 times a TOMS solve);
    returns (on the CPU, the launch: the argument array without pointers,
    the launcher, the device index and the workspace's size in elements;
    None on the CPU or with no states)."""
    name = "sine_solve2d"
    keys = [k for k, p in zip(_SOLVE_KEYS, present) if p]
    _check_facts(name, facts, keys.__getitem__)
    f = dict(zip(keys, facts))
    dtype, device, bshape, bstride = f["b"]
    if len(bshape) != 3:
        _require(False, name, f"b has shape {tuple(bshape)}, expected (B, r, c)")
    B, r, c = bshape
    P, Q = (r + 2, c + 2) if "ring" in f else (r, c)
    _state_facts(name, "out", f["out"][2], B, P, Q)
    if "g" in f:
        _state_facts(name, "g", f["g"][2], B, P, Q)
    if not (tuple(f["Sx"][2]) == (r, r) and tuple(f["Sy"][2]) == (c, c)
            and _contiguous(*f["Sx"][2:]) and _contiguous(*f["Sy"][2:])):
        _require(False, name, f"Sx and Sy must be contiguous ({r}, {r}) and ({c}, {c}) bases")
    if ("lam" in f) != has_shift:
        _require(False, name, "lam and shift go together")
    if "lam" in f and not (tuple(f["lam"][2]) == (r, c) and _contiguous(*f["lam"][2:])):
        _require(False, name, f"lam must be a contiguous ({r}, {c}) table")
    if "shift" in f and not (tuple(f["shift"][2]) == (B,) and _contiguous(*f["shift"][2:])):
        _require(False, name, f"a shift tensor must be a contiguous ({B},) vector")
    if "ring" in f and not (tuple(f["ring"][2]) == (P, Q) and _contiguous(*f["ring"][2:])):
        _require(False, name, f"ring must be a contiguous ({P}, {Q}) field")
    if device.type == "cpu" or B == 0:
        return device.type == "cpu", None
    chunk = min(B, TILED_CHUNK) if max(r, c) > ONE_TILE else 0
    gs = f["g"][3][:2] if "g" in f else (0, 0)
    args = solve_pack(device.index, bstride[:2], f["out"][3][:2], gs, B, r, c, chunk)
    return False, (args, _launcher("pm_sine_solve2d", dtype), device.index,
                   solve_workspace(dtype, r, c, chunk))


def solve_workspace(dtype, r, c, chunk):
    """Elements of K5's workspace past the one-tile side (0 within it):
    float64, copies of Sx and Sy with rows of even length and the band
    products' two buffers of a chunk of states, (c x r) and (r x c) with
    rows of even length (csrc/sine_solve2d.cu ``band_dmma``); float32, the
    tiled path's two (r x c) buffers."""
    if not chunk:
        return 0
    if dtype == torch.float64:
        ldr, ldc = r + r % 2, c + c % 2
        return r * ldr + c * ldc + chunk * (c * ldr + r * ldc)
    return 2 * chunk * r * c


def solve_pack(index, bs, os, gs, B, r, c, chunk):
    """The launcher's int64 argument array (csrc/sine_solve2d.cu
    ``launch``): device, eight operand pointers and the workspace's (filled
    in by each call), b's, out's and g's batch and row strides, B, r, c,
    the workspace's chunk of states."""
    return array.array("q", (index, *(0,) * 9, *bs, *os, *gs, B, r, c, chunk))


def sine_solve2d(b, out, Sx, Sy, lam=None, shift=None, ring=None, g=None):
    """Batched implicit solve (lam and shift given) or two-sided transform
    (neither) of B states.

    b: (B, r, c) view; out: (B, r, c) view, or (B, r + 2, c + 2) with ring,
    an (r + 2, c + 2) field whose boundary ring out receives; Sx (r, r),
    Sy (c, c) symmetric bases; lam: (r, c) eigenvalue sums; shift: a float
    or a (B,) tensor; g: optional view of out's shape added to the result.
    Contiguous tables.  out must not overlap b.  Returns out.
    """
    shift_t = shift if isinstance(shift, torch.Tensor) else None
    ops = (b, out, Sx, Sy, lam, ring, g, shift_t)
    on_cpu, launch = _solve_checked(tuple(fact(t) for t in ops if t is not None),
                                    tuple(t is not None for t in ops), shift is not None)
    if on_cpu:
        return sine_solve2d_plain(b, out, Sx, Sy, lam, shift, ring, g)
    if launch is None:
        return out
    tmpl, fn, index, ws_size = launch
    args = tmpl[:]
    for k, t in enumerate(ops):
        if t is not None:
            args[1 + k] = t.data_ptr()
    ws = None
    if ws_size:
        ws = torch.empty(ws_size, dtype=b.dtype, device=b.device)
        args[9] = ws.data_ptr()
    shift0 = float(shift) if shift is not None and shift_t is None else 0.0
    _build.check(fn(args.buffer_info()[0], shift0, _build.stream(index)), "sine_solve2d")
    sine_solve2d.launches += 1
    return out


sine_solve2d.launches = 0


def sine_affine2d_plain(xhat, A, G, out, Sx, Sy, r0=0, ring=None, dhat=None, dscale=None,
                        seed=None, seed_out=None):
    """out[j, r] = Sx (xhat_j A[r0+r] + G[r0+r] [+ (dhat_j dscale) A[r0+r-1]]) Sy
    (A[-1] = 1), with the ring; seed_out[j] = seed[j]."""
    J, R = out.shape[:2]
    r, c = Sx.shape[0], Sy.shape[0]
    yhat = xhat[:, None] * A[None, r0:r0 + R] + G[None, r0:r0 + R]
    if dhat is not None:
        A_km1 = torch.cat([torch.ones_like(A[:1]), A[:-1]])[r0:r0 + R]
        yhat = yhat + (dhat * dscale)[:, None] * A_km1[None]
    y = torch.matmul(torch.matmul(Sx, yhat.view(J, R, r, c)), Sy)
    out.copy_(y if ring is None else _with_ring(y, out, ring))
    if seed_out is not None:
        seed_out.copy_(seed)
    return out


def sine_affine2d(xhat, A, G, out, Sx, Sy, r0=0, ring=None, dhat=None, dscale=None,
                  seed=None, seed_out=None):
    """Physical closed-form interval relaxation into ``out``.

    xhat: (J, N) transformed seed interiors, N = r * c; A, G: (T, N)
    contiguous tables; out: (J, R, r, c) view, or (J, R, r + 2, c + 2) with
    ring, with any interval and row strides; rows r0..r0+R-1 of the tables;
    dhat: optional (J, N) transformed ring corrections with dscale (N,), the
    CN correction (dhat * dscale) * A[k-1]; seed, seed_out: optional (J, P, Q)
    views, seed_out receives a copy of seed.  Returns out.
    """
    name = "sine_affine2d"
    ops = dict(xhat=xhat, A=A, G=G, out=out, Sx=Sx, Sy=Sy)
    for key, t in dict(ring=ring, dhat=dhat, dscale=dscale, seed=seed,
                       seed_out=seed_out).items():
        if t is not None:
            ops[key] = t
    _check_operands(name, ops)
    r, c = Sx.shape[0], Sy.shape[0]
    N = r * c
    _require(xhat.dim() == 2 and xhat.shape[1] == N, name,
             f"xhat has shape {tuple(xhat.shape)}, expected (J, {N})")
    J = xhat.shape[0]
    _require(Sx.dim() == 2 and Sy.dim() == 2 and Sx.shape[1] == r and Sy.shape[1] == c
             and Sx.is_contiguous() and Sy.is_contiguous(), name,
             "Sx and Sy must be contiguous square bases")
    _require(A.dim() == 2 and A.shape == G.shape and A.shape[1] == N
             and A.is_contiguous() and G.is_contiguous(), name,
             "A and G must be contiguous (T, N) tables")
    P, Q = (r + 2, c + 2) if ring is not None else (r, c)
    _require(out.dim() == 4 and out.shape[0] == J and tuple(out.shape[2:]) == (P, Q), name,
             f"out has shape {tuple(out.shape)}, expected ({J}, R, {P}, {Q})")
    R = out.shape[1]
    _require(0 <= r0 and r0 + R <= A.shape[0], name,
             f"rows {r0}..{r0 + R - 1} outside the {A.shape[0]}-row table")
    _require(ring is None or (tuple(ring.shape) == (P, Q) and ring.is_contiguous()), name,
             f"ring must be a contiguous ({P}, {Q}) field")
    _require((dhat is None) == (dscale is None), name, "dhat and dscale go together")
    _require(dhat is None or (tuple(dhat.shape) == (J, N) and tuple(dscale.shape) == (N,)),
             name, f"dhat must be ({J}, {N}) and dscale ({N},)")
    _require((seed is None) == (seed_out is None), name, "seed and seed_out go together")
    if seed is not None:
        _state_view(name, "seed", seed, J, P, Q)
        _state_view(name, "seed_out", seed_out, J, P, Q)
    if xhat.device.type == "cpu":
        return sine_affine2d_plain(xhat, A, G, out, Sx, Sy, r0, ring, dhat, dscale, seed,
                                   seed_out)
    if J == 0 or R == 0:
        return out
    ws, chunk = tiled_workspace(J * R, r, c, xhat)
    fn = _launcher("pm_sine_affine2d", xhat.dtype)
    stream = torch.cuda.current_stream(xhat.device).cuda_stream
    status = fn(xhat.data_ptr(), xhat.stride(0), A.data_ptr(), G.data_ptr(), r0, R, J,
                dhat.data_ptr() if dhat is not None else None,
                dhat.stride(0) if dhat is not None else 0,
                dscale.data_ptr() if dscale is not None else None,
                out.data_ptr(), out.stride(0), out.stride(1), out.stride(2),
                seed.data_ptr() if seed is not None else None,
                seed.stride(0) if seed is not None else 0,
                seed.stride(1) if seed is not None else 0,
                seed_out.data_ptr() if seed_out is not None else None,
                seed_out.stride(0) if seed_out is not None else 0,
                seed_out.stride(1) if seed_out is not None else 0,
                Sx.data_ptr(), Sy.data_ptr(), ring.data_ptr() if ring is not None else None,
                ws.data_ptr() if ws is not None else None, chunk, r, c, stream)
    _build.check(status, name)
    sine_affine2d.launches += 1
    return out


sine_affine2d.launches = 0


# ---------------------------------------------------------------------------
# K20 sine_solve1d: physical-basis Heat1D step (BE, BDF2) and 1D sine transform
# ---------------------------------------------------------------------------


def sine_solve1d_plain(x, out, S, lam=None, dt=None, rhs=None, second=None, c2=None, c1=None,
                       coeff=None):
    """out = ((x + dt rhs) S / (1 + dt lam)) S row by row (BE), or
    (((rhs - c2 x) + c1 second) S / (lam + coeff)) S (BDF2), or x S without
    lam (the expressions of Heat1D.step_batched, Heat1DBDF2.step)."""
    if lam is None:
        y = x @ S
    elif coeff is not None:
        b = (rhs - c2[:, None] * x) + c1[:, None] * second
        y = ((b @ S) / (lam[None] + coeff[:, None])) @ S
    else:
        d = dt[:, None]
        b = x if rhs is None else x + d * rhs
        y = ((b @ S) / (1.0 + d * lam[None])) @ S
    out.copy_(y.view(out.shape))
    return out


def sine_solve1d(x, out, S, lam=None, dt=None, rhs=None, second=None, c2=None, c1=None,
                 coeff=None):
    """Batched physical Heat1D backward-Euler step (lam and dt given), BDF2
    step (lam, rhs, second, c2, c1 and coeff given) or 1D sine transform
    (none) of B rows of n values (K20).

    x: (B, n) view; out: a (B, n) view, or an (H, D, n) view with H * D = B
    (row b at [b // D, b % D]); S: contiguous (n, n) symmetric basis; lam:
    contiguous (n,) eigenvalues; dt: contiguous (B,) step sizes; rhs:
    (B, n) view (row stride 0 for one shared row), added as dt * rhs before
    the BE solve (optional there), or BDF2's right-hand side
    (rhs - c2 x) + c1 second with second a (B, n) view and c2, c1, coeff
    contiguous (B,) per-lane coefficients; BDF2 divides by lam + coeff.  A
    solve may write over its inputs; a transform's out must not share memory
    with x.  Returns out.
    """
    name = "sine_solve1d"
    ops = dict(x=x, out=out, S=S)
    for key, t in dict(lam=lam, dt=dt, rhs=rhs, second=second, c2=c2, c1=c1,
                       coeff=coeff).items():
        if t is not None:
            ops[key] = t
    _check_operands(name, ops)
    _require(x.dim() == 2, name, f"x has shape {tuple(x.shape)}, expected (B, n)")
    B, n = x.shape
    _require(out.dim() in (2, 3) and out.shape[-1] == n and out[..., 0].numel() == B, name,
             f"out has shape {tuple(out.shape)}, expected ({B}, {n}) or (H, D, {n}), H * D = {B}")
    _require(tuple(S.shape) == (n, n) and S.is_contiguous(), name,
             f"S must be a contiguous ({n}, {n}) basis")
    bdf2 = coeff is not None
    _require(not bdf2 or (lam is not None and dt is None and rhs is not None
                          and second is not None and c2 is not None and c1 is not None), name,
             "BDF2 takes lam, rhs, second, c2, c1 and coeff (and no dt)")
    _require(bdf2 or (second is None and c2 is None and c1 is None), name,
             "second, c2 and c1 belong to BDF2 (with coeff)")
    _require(bdf2 or (lam is None) == (dt is None), name, "lam and dt go together")
    _require(rhs is None or lam is not None, name, "rhs needs lam and dt")
    _require(lam is None or (tuple(lam.shape) == (n,) and lam.is_contiguous()), name,
             f"lam must be a contiguous ({n},) vector")
    for key, t in dict(dt=dt, c2=c2, c1=c1, coeff=coeff).items():
        _require(t is None or (tuple(t.shape) == (B,) and t.is_contiguous()), name,
                 f"{key} must be a contiguous ({B},) vector")
    for key, t in dict(rhs=rhs, second=second).items():
        _require(t is None or tuple(t.shape) == (B, n), name,
                 f"{key} has shape {tuple(t.shape) if t is not None else None}, "
                 f"expected ({B}, {n})")
    _require(lam is not None or out.untyped_storage().data_ptr() != x.untyped_storage().data_ptr(),
             name, "a transform's out shares memory with x")
    if x.device.type == "cpu":
        return sine_solve1d_plain(x, out, S, lam, dt, rhs, second, c2, c1, coeff)
    if B == 0 or n == 0:
        return out
    D, s_hi, s_lo = (1, out.stride(0), 0) if out.dim() == 2 else (
        out.shape[1], out.stride(0), out.stride(1))
    work = torch.empty((B, n), dtype=x.dtype, device=x.device) if lam is not None else None

    def ptr(t):
        return t.data_ptr() if t is not None else None

    fn = _launcher("pm_sine_solve1d", x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = fn(x.data_ptr(), x.stride(0), ptr(second), second.stride(0) if bdf2 else 0,
                ptr(rhs), rhs.stride(0) if rhs is not None else 0, ptr(dt), ptr(c2), ptr(c1),
                S.data_ptr(), ptr(lam), ptr(coeff), ptr(work), out.data_ptr(), D, s_hi, s_lo,
                B, n, stream)
    _build.check(status, name)
    sine_solve1d.launches += 1
    sine_solve1d.mode_launches["bdf2" if bdf2 else "be" if lam is not None else "transform"] += 1
    return out


sine_solve1d.launches = 0
sine_solve1d.mode_launches = {"be": 0, "bdf2": 0, "transform": 0}   # launches by mode


# ---------------------------------------------------------------------------
# K23 dd_interval_affine, K24 dd_theta_chain: K1 and K2 in double-double
# ---------------------------------------------------------------------------

# elements of a plain DD expression evaluated at once (its ~20 float32
# temporaries then take ~1.3 GB)
_DD_PLAIN_CHUNK = 1 << 24


def _check_dd(name: str, operands: dict) -> None:
    """DD operands: float32 pairs on one device, hi and lo strided alike,
    contiguous in the last axis."""
    for key, x in operands.items():
        _require(hasattr(x, "hi") and hasattr(x, "lo"), name, f"{key} must be a DD pair")
    ref = next(iter(operands.values())).hi
    _require(ref.device.type in ("cpu", "cuda"), name, f"unsupported device {ref.device}")
    for key, x in operands.items():
        for t in (x.hi, x.lo):
            _require(t.dtype == torch.float32, name, f"{key} must be float32 pairs")
            _require(t.device == ref.device, name, f"{key} is on {t.device}, expected {ref.device}")
        _require(x.hi.shape == x.lo.shape and x.hi.stride() == x.lo.stride(), name,
                 f"{key}: hi and lo must have one shape and one set of strides")
        _require(x.hi.shape[-1] <= 1 or x.hi.stride(-1) == 1, name,
                 f"{key} must be contiguous in its last axis")


def dd_interval_affine_plain(x, A, G, out, r0=0, seed_out=None):
    """out[j, r] = A[r0 + r] (x) x[j] (+) G[r0 + r] in DD; seed_out[j] = x[j]
    (a chunk of intervals at a time)."""
    from pymgrit_tpu_torch.ops import dd as _dd
    J, R, N = out.shape
    a = (A.hi[None, r0:r0 + R], A.lo[None, r0:r0 + R])
    g = (G.hi[None, r0:r0 + R], G.lo[None, r0:r0 + R])
    step = max(1, _DD_PLAIN_CHUNK // max(1, R * N))
    for j0 in range(0, J, step):
        s = slice(j0, min(J, j0 + step))
        hi, lo = _dd._add(_dd._mul(a, (x.hi[s, None], x.lo[s, None])), g)
        out.hi[s].copy_(hi)
        out.lo[s].copy_(lo)
    if seed_out is not None:
        seed_out.hi.copy_(x.hi)
        seed_out.lo.copy_(x.lo)
    return out


def dd_interval_affine(x, A, G, out, r0=0, seed_out=None):
    """K1's closed-form interval relaxation in double-double, into ``out``
    (K23).

    x: (J, N) DD seeds; A, G: (T, N) contiguous DD tables; out: (J, R, N) DD
    view with any interval and row strides, rows r0..r0+R-1 of the tables;
    seed_out: optional (J, N) DD view that receives a copy of x.  hi and lo
    of each operand share strides (a packed tube, lo = hi + N, or separate
    tensors).  Returns out.
    """
    name = "dd_interval_affine"
    ops = dict(x=x, A=A, G=G, out=out)
    if seed_out is not None:
        ops["seed_out"] = seed_out
    _check_dd(name, ops)
    J, N = x.shape
    R = out.shape[1]
    _require(A.ndim == 2 and A.shape == G.shape and A.shape[1] == N
             and all(t.is_contiguous() for t in (A.hi, A.lo, G.hi, G.lo)), name,
             "A and G must be contiguous (T, N) DD tables")
    _require(out.ndim == 3 and out.shape[0] == J and out.shape[2] == N, name,
             f"out has shape {tuple(out.shape)}, expected ({J}, R, {N})")
    _require(0 <= r0 and r0 + R <= A.shape[0], name,
             f"rows {r0}..{r0 + R - 1} outside the {A.shape[0]}-row table")
    _require(seed_out is None or tuple(seed_out.shape) == (J, N), name,
             "seed_out must have the shape of x")
    if x.hi.device.type == "cpu":
        return dd_interval_affine_plain(x, A, G, out, r0, seed_out)
    if J == 0 or N == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(x.hi.device).cuda_stream
    so = seed_out
    status = lib.pm_dd_interval_affine(
        x.hi.data_ptr(), x.lo.data_ptr(), x.hi.stride(0), A.hi.data_ptr(), A.lo.data_ptr(),
        G.hi.data_ptr(), G.lo.data_ptr(), r0, R, J, N, out.hi.data_ptr(), out.lo.data_ptr(),
        out.hi.stride(0), out.hi.stride(1), so.hi.data_ptr() if so is not None else None,
        so.lo.data_ptr() if so is not None else None, so.hi.stride(0) if so is not None else 0,
        stream)
    _build.check(status, name)
    dd_interval_affine.launches += 1
    return out


dd_interval_affine.launches = 0


def dd_theta_chain_plain(x0, out, dt, lam, lift, rhs1, rhs0, theta, g=None):
    """J chains of L spectral theta-steps in DD, in the expression order of
    the JAX package's ``Heat2D._step_spectral`` (see csrc/dd_theta_chain.cu)."""
    from pymgrit_tpu_torch.ops import dd as _dd
    f32 = torch.float32
    th = tuple(torch.tensor(v, dtype=f32) for v in _dd._split_f64(theta))
    two, one = (torch.tensor(2.0, dtype=f32), torch.tensor(0.0, dtype=f32)), \
        (torch.tensor(1.0, dtype=f32), torch.tensor(0.0, dtype=f32))
    lm, lf = (lam.hi, lam.lo), (lift.hi, lift.lo)
    x = (x0.hi, x0.lo)
    for k in range(out.shape[1]):
        d = (dt.hi[k][:, None], dt.lo[k][:, None])
        shift = _dd._mul(d, th)
        zero = torch.zeros((), dtype=f32)
        if theta == 1.0:
            b = _dd._add(_dd._add(x, _dd._mul(d, (rhs1[k], zero))), _dd._mul(shift, lf))
        else:
            r = torch.tensor(float(theta), dtype=f32) * rhs1[k] \
                + torch.tensor(1.0 - float(theta), dtype=f32) * rhs0[k]
            b = _dd._add(x, _dd._neg(_dd._mul(shift, _dd._mul(x, lm))))
            b = _dd._add(b, _dd._mul(_dd._mul(shift, two), lf))
            b = _dd._add(b, _dd._mul(d, (r, zero)))
        x = _dd._div(b, _dd._add(_dd._mul(shift, lm), one))
        if g is not None:
            x = _dd._add((g.hi[:, k], g.lo[:, k]), x)
        out.hi[:, k] = x[0]
        out.lo[:, k] = x[1]
    return out


def dd_theta_chain(x0, out, dt, lam, lift, rhs1, rhs0, theta, g=None):
    """K2's sequential spectral theta-steps of J chains in double-double,
    every step written (K24).

    x0: (J, N) DD seeds; out: (J, L, N) DD view; g: optional (J, L, N) DD
    view added after each step; dt: (L, J) contiguous DD step sizes; lam,
    lift: (N,) contiguous DD eigenvalues and lifted boundary data; rhs1,
    rhs0: (L, J, N) float32 views of the rhs at the step's end and start
    (strides 0 for a time-independent rhs; rhs0 is read only when theta !=
    1); theta: 1 (BE) or 0.5 (CN).  out must not overlap x0 or g.  Returns
    out.
    """
    name = "dd_theta_chain"
    ops = dict(x0=x0, out=out, dt=dt, lam=lam, lift=lift)
    if g is not None:
        ops["g"] = g
    _check_dd(name, ops)
    J, N = x0.shape
    L = out.shape[1]
    _require(out.ndim == 3 and out.shape[0] == J and out.shape[2] == N, name,
             f"out has shape {tuple(out.shape)}, expected ({J}, L, {N})")
    _require(g is None or g.shape == out.shape, name, "g must have the shape of out")
    _require(tuple(dt.shape) == (L, J) and dt.hi.is_contiguous(), name,
             f"dt must be a contiguous ({L}, {J}) DD table")
    _require(tuple(lam.shape) == (N,) and tuple(lift.shape) == (N,), name,
             "lam and lift must have shape (N,)")
    for key, r in (("rhs1", rhs1), ("rhs0", rhs0)):
        _require(r.dtype == torch.float32 and r.device == x0.hi.device, name,
                 f"{key} must be a float32 tensor on {x0.hi.device}")
        _require(r.shape[-1] <= 1 or r.stride(-1) == 1, name,
                 f"{key} must be contiguous in its last axis")
    _require(rhs1.shape == (L, J, N) and rhs0.shape == rhs1.shape
             and rhs0.stride() == rhs1.stride(), name,
             "rhs1 and rhs0 must be (L, J, N) views with equal strides")
    _require(float(theta) > 0.0, name, "theta must be > 0 (BE or CN)")
    if x0.hi.device.type == "cpu":
        return dd_theta_chain_plain(x0, out, dt, lam, lift, rhs1, rhs0, theta, g)
    if J == 0 or L == 0 or N == 0:
        return out
    ptrs = [x0.hi.data_ptr(), x0.lo.data_ptr(), out.hi.data_ptr(), out.lo.data_ptr(),
            g.hi.data_ptr() if g is not None else None, g.lo.data_ptr() if g is not None else None,
            dt.hi.data_ptr(), dt.lo.data_ptr(), lam.hi.data_ptr(), lam.lo.data_ptr(),
            lift.hi.data_ptr(), lift.lo.data_ptr(), rhs1.data_ptr(), rhs0.data_ptr()]
    strides = [x0.hi.stride(0), out.hi.stride(0), out.hi.stride(1),
               g.hi.stride(0) if g is not None else 0, g.hi.stride(1) if g is not None else 0,
               rhs1.stride(0), rhs1.stride(1)]
    status = _build.library().pm_dd_theta_chain(
        (ctypes.c_void_p * 14)(*ptrs), (ctypes.c_int64 * 7)(*strides), float(theta),
        (ctypes.c_int64 * 3)(J, L, N), torch.cuda.current_stream(x0.hi.device).cuda_stream)
    _build.check(status, name)
    dd_theta_chain.launches += 1
    return out


dd_theta_chain.launches = 0
