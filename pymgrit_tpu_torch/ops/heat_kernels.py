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
BDF pair state) as a row of n interior values, and runs its two products
on the FP64 product tile that K22 and K26 share (``csrc/dmma_tile.cuh``,
plans from ``product_tile.lanes_plan``) through a device workspace it keeps
per device, stream and dtype (``_solve1d_workspace``).  K1, K2, K5, K6,
K20, K23 and K24 take the one-call launch path: every check, the plan and the
packed int64 argument array are cached by the operands' facts, and a
launch is one ctypes call.
"""

from __future__ import annotations

import array
import functools
import math

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


# K2's block (csrc/theta_chain.cu: kThreads): an item is one chain's segment
# of K2_THREADS x (16 bytes' worth) coefficients
K2_THREADS = 256


def theta_chain_plan(J, N, es):
    """(vector width, segments a chain, grid) of one K2 launch: J chains of
    N coefficients of es bytes.  A thread owns 16 bytes' worth of
    coefficients; an item is one chain's segment of K2_THREADS threads; one
    block an item (the hardware starts the next item's block as one
    retires)."""
    vec = 16 // es
    segs = -(-N // (K2_THREADS * vec))
    return vec, segs, max(1, min(J * segs, 2 ** 31 - 1))


def theta_chain_pack(index, strides, J, L, N, cn, has_g, tab, plan):
    """The launcher's int64 argument array (csrc/theta_chain.cu ``launch``):
    device, eight operand pointers (filled in by each call: x0, out, g, dt,
    lam, lift, rhs1, rhs0), the strides (x0's chain stride, out's chain and
    step strides, g's chain and step strides, the rhs rows' step and chain
    strides), J, L, N, segments a chain, grid, CN, g present, rhs
    tabulated, vector width."""
    vec, segs, grid = plan
    return array.array("q", (index, *(0,) * 8, *strides, J, L, N, segs, grid, int(cn),
                             int(has_g), int(tab), vec))


@functools.lru_cache(maxsize=1024)
def _chain_checked(facts, theta):
    """Every check of a K2 call, on the ``fact``s of x0, out, dt, lam, lift,
    rhs1, rhs0 (and g) and theta, cached by them (K2 runs at every
    coarse-level F- and C-relaxation, FAS residual and coarsest solve: the
    checks' host time is paid once a shape); returns (on the CPU, the
    launch: the argument array without pointers, the launcher and the
    device index; None on the CPU or with nothing to do)."""
    name = "theta_chain"
    keys = ("x0", "out", "dt", "lam", "lift", "rhs1", "rhs0", "g")
    _check_facts(name, facts, keys.__getitem__)
    f = dict(zip(keys, facts))
    dtype, device, xshape, xstride = f["x0"]
    if len(xshape) != 2:
        _require(False, name, f"x0 has shape {tuple(xshape)}, expected (J, N)")
    J, N = xshape
    oshape, ostride = f["out"][2:]
    if not (len(oshape) == 3 and oshape[0] == J and oshape[2] == N):
        _require(False, name, f"out has shape {tuple(oshape)}, expected ({J}, L, {N})")
    L = oshape[1]
    if "g" in f and f["g"][2] != oshape:
        _require(False, name, "g must have the shape of out")
    if not (tuple(f["dt"][2]) == (L, J) and _contiguous(*f["dt"][2:])):
        _require(False, name, f"dt must be a contiguous ({L}, {J}) tensor")
    if not (tuple(f["lam"][2]) == (N,) and tuple(f["lift"][2]) == (N,)):
        _require(False, name, "lam and lift must have shape (N,)")
    r1, r0 = f["rhs1"], f["rhs0"]
    if not (tuple(r1[2]) == (L, J, N) and r0[2] == r1[2] and r0[3] == r1[3]):
        _require(False, name, "rhs1 and rhs0 must be (L, J, N) views with equal strides")
    if not theta > 0.0:
        _require(False, name, "theta must be > 0 (BE or CN)")
    if device.type == "cpu" or J * L * N == 0:
        return device.type == "cpu", None
    gs = f["g"][3][:2] if "g" in f else (0, 0)
    r_sk, r_sj = r1[3][0] if L > 1 else 0, r1[3][1] if J > 1 else 0
    args = theta_chain_pack(device.index, (xstride[0], *ostride[:2], *gs, r_sk, r_sj), J, L, N,
                            theta != 1.0, "g" in f, (r_sk, r_sj) != (0, 0),
                            theta_chain_plan(J, N, dtype.itemsize))
    return False, (args, _launcher("pm_theta_chain", dtype), device.index)


def theta_chain(x0, out, dt, lam, lift, rhs1, rhs0, theta, g=None):
    """Sequential spectral theta-steps of J chains, every step written.

    x0: (J, N) seeds; out: (J, L, N) view; g: optional (J, L, N) view added
    after each step; dt: (L, J) contiguous step sizes; lam, lift: (N,)
    eigenvalues and lifted boundary data; rhs1, rhs0: (L, J, N) views of the
    rhs at the step's end and start (strides 0 for a time-independent rhs;
    rhs0 is read only when theta != 1).  out must not overlap x0 or g.
    Every operand's last axis must be contiguous.  Returns out.
    """
    ops = (x0, out, dt, lam, lift, rhs1, rhs0) if g is None else \
        (x0, out, dt, lam, lift, rhs1, rhs0, g)
    theta = float(theta)
    on_cpu, launch = _chain_checked(tuple(map(fact, ops)), theta)
    if on_cpu:
        return theta_chain_plain(x0, out, dt, lam, lift, rhs1, rhs0, theta, g)
    if launch is None:
        return out
    tmpl, fn, index = launch
    args = tmpl[:]
    args[1], args[2] = x0.data_ptr(), out.data_ptr()
    if g is not None:
        args[3] = g.data_ptr()
    args[4], args[5], args[6] = dt.data_ptr(), lam.data_ptr(), lift.data_ptr()
    args[7], args[8] = rhs1.data_ptr(), rhs0.data_ptr()
    _build.check(fn(args.buffer_info()[0], theta, 1.0 - theta, _build.stream(index)),
                 "theta_chain")
    theta_chain.launches += 1
    return out


theta_chain.launches = 0


# ---------------------------------------------------------------------------
# K5 sine_solve2d, K6 sine_affine2d: physical-basis two-sided sine products
# ---------------------------------------------------------------------------

ONE_TILE = 128       # largest side of the one-tile cores (csrc/sine2d.cuh, sine2d_dmma.cuh)
TILED_CHUNK = 512    # states the tiled paths stage at a time


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
    """Elements of K5's and K6's workspace past the one-tile side (0 within
    it):
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


# sine_affine2d's operands in the order of its argument array's pointer
# slots 1-11 (csrc/sine_affine2d.cu ``launch``; slot 12 the workspace)
_AFFINE_KEYS = ("xhat", "A", "G", "out", "Sx", "Sy", "ring", "dhat", "dscale", "seed",
                "seed_out")


@functools.lru_cache(maxsize=1024)
def _affine_checked(facts, present, r0):
    """Every check of a K6 call, on the ``fact``s of the operands given
    (``present``: which of ``_AFFINE_KEYS``) and r0, cached by them;
    returns (on the CPU, the launch: the argument array without pointers,
    the launcher, the device index and the workspace's size in elements;
    None on the CPU or with no states)."""
    name = "sine_affine2d"
    keys = [k for k, p in zip(_AFFINE_KEYS, present) if p]
    _check_facts(name, facts, keys.__getitem__)
    f = dict(zip(keys, facts))
    dtype, device, xshape, xstride = f["xhat"]
    (_, _, sxs, sxt), (_, _, sys_, syt) = f["Sx"], f["Sy"]
    if not (len(sxs) == 2 and len(sys_) == 2 and sxs[0] == sxs[1] and sys_[0] == sys_[1]
            and _contiguous(sxs, sxt) and _contiguous(sys_, syt)):
        _require(False, name, "Sx and Sy must be contiguous square bases")
    r, c = sxs[0], sys_[0]
    N = r * c
    if not (len(xshape) == 2 and xshape[1] == N):
        _require(False, name, f"xhat has shape {tuple(xshape)}, expected (J, {N})")
    J = xshape[0]
    ash, gsh = f["A"][2], f["G"][2]
    if not (len(ash) == 2 and ash == gsh and ash[1] == N and _contiguous(*f["A"][2:])
            and _contiguous(*f["G"][2:])):
        _require(False, name, "A and G must be contiguous (T, N) tables")
    P, Q = (r + 2, c + 2) if "ring" in f else (r, c)
    osh, ost = f["out"][2], f["out"][3]
    if not (len(osh) == 4 and osh[0] == J and tuple(osh[2:]) == (P, Q)):
        _require(False, name, f"out has shape {tuple(osh)}, expected ({J}, R, {P}, {Q})")
    R = osh[1]
    if not (0 <= r0 and r0 + R <= ash[0]):
        _require(False, name, f"rows {r0}..{r0 + R - 1} outside the {ash[0]}-row table")
    if "ring" in f and not (tuple(f["ring"][2]) == (P, Q) and _contiguous(*f["ring"][2:])):
        _require(False, name, f"ring must be a contiguous ({P}, {Q}) field")
    if ("dhat" in f) != ("dscale" in f):
        _require(False, name, "dhat and dscale go together")
    if "dhat" in f and not (tuple(f["dhat"][2]) == (J, N) and tuple(f["dscale"][2]) == (N,)):
        _require(False, name, f"dhat must be ({J}, {N}) and dscale ({N},)")
    if ("seed" in f) != ("seed_out" in f):
        _require(False, name, "seed and seed_out go together")
    if "seed" in f:
        _state_facts(name, "seed", f["seed"][2], J, P, Q)
        _state_facts(name, "seed_out", f["seed_out"][2], J, P, Q)
    if device.type == "cpu" or J * R == 0:
        return device.type == "cpu", None
    chunk = min(J * R, TILED_CHUNK) if max(r, c) > ONE_TILE else 0
    ds = f["dhat"][3][0] if "dhat" in f else 0
    ss = f["seed"][3][:2] if "seed" in f else (0, 0)
    sos = f["seed_out"][3][:2] if "seed" in f else (0, 0)
    args = affine_pack(device.index, (xstride[0], ds), ost[:3], ss, sos, r0, R, J, r, c, chunk)
    return False, (args, _launcher("pm_sine_affine2d", dtype), device.index,
                   solve_workspace(dtype, r, c, chunk))


def affine_pack(index, xds, os, ss, sos, r0, R, J, r, c, chunk):
    """The launcher's int64 argument array (csrc/sine_affine2d.cu
    ``launch``): device, eleven operand pointers and the workspace's
    (filled in by each call), xhat's and dhat's interval strides, out's
    interval, row and state-row strides, seed's and seed_out's interval and
    state-row strides, r0, R, J, r, c, the workspace's chunk of states."""
    return array.array("q", (index, *(0,) * 12, *xds, *os, *ss, *sos, r0, R, J, r, c, chunk))


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
    ops = (xhat, A, G, out, Sx, Sy, ring, dhat, dscale, seed, seed_out)
    on_cpu, launch = _affine_checked(tuple(fact(t) for t in ops if t is not None),
                                     tuple(t is not None for t in ops), r0)
    if on_cpu:
        return sine_affine2d_plain(xhat, A, G, out, Sx, Sy, r0, ring, dhat, dscale, seed,
                                   seed_out)
    if launch is None:
        return out
    tmpl, fn, index, ws_size = launch
    args = tmpl[:]
    for k, t in enumerate(ops):
        if t is not None:
            args[1 + k] = t.data_ptr()
    ws = None
    if ws_size:
        ws = torch.empty(ws_size, dtype=xhat.dtype, device=xhat.device)
        args[12] = ws.data_ptr()
    _build.check(fn(args.buffer_info()[0], _build.stream(index)), "sine_affine2d")
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
    lam (the expressions of Heat1D.step_batched, Heat1DBDF2.step); a (D, n)
    lam table (BE) gives row b the table's row b % D."""
    if lam is not None:
        lam = lam[None] if lam.dim() == 1 else lam.repeat(x.shape[0] // lam.shape[0], 1)
    if lam is None:
        y = x @ S
    elif coeff is not None:
        b = (rhs - c2[:, None] * x) + c1[:, None] * second
        y = ((b @ S) / (lam + coeff[:, None])) @ S
    else:
        d = dt[:, None]
        b = x if rhs is None else x + d * rhs
        y = ((b @ S) / (1.0 + d * lam)) @ S
    out.copy_(y.view(out.shape))
    return out


_K20_KEYS = ("x", "out", "S", "lam", "dt", "rhs", "second", "c2", "c1", "coeff")
_K20_MODES = ("transform", "be", "be", "bdf2")      # mode_launches' key of each launcher mode


def k20_prepass(B, n, mode):
    """Whether a K20 call of B lanes of n values in this launcher mode forms
    its right-hand side in a first pass into the workspace (else its first
    product forms it as it stages the lanes): on the wide tile, where two or
    three components in the ring leave one block an SM and the first
    product ran far slower than a plain one."""
    from pymgrit_tpu_torch.ops import product_tile
    return mode >= 2 and product_tile.lanes_regime(B, n) == "wide"


def k20_fused(n, mode):
    """Whether a K20 solve (launcher mode >= 1) runs both products in one
    launch: where one k-tile of the skinny tile holds the inner index (the
    block then holds S's whole tile and its lanes' work rows)."""
    from pymgrit_tpu_torch.ops import product_tile
    return mode >= 1 and n <= product_tile.SKINNY[2]


def sine_solve1d_plan(B, n, dtype, mode, mods):
    """The two product plans of a K20 call (``product_tile.lanes_plan``):
    the first product's (its lane components staged: 1, 2 with BE's dt r, 3
    in BDF2; 1 where a first pass forms them, ``k20_prepass``) and the
    second's, on the contiguous work rows (None for a transform).  mode as
    the launcher takes it (0 transform, 1 BE, 2 BE + dt r, 3 BDF2); mods:
    (x's, r's, second's, S's, x's row stride's) offsets from 16-byte
    alignment in bytes (r's and second's None where absent; a row stride
    of 0 for r shared by every row)."""
    from pymgrit_tpu_torch.ops import product_tile
    es = 8 if dtype == torch.float64 else 4
    dname = str(dtype).split(".")[-1]
    copy = product_tile.copy_bytes
    x_mod, r_mod, x2_mod, s_mod, strides = mods
    table = copy((s_mod,), (0, n, 1), (1, n, n), es)
    work = copy((0,), (0, n, 1), (1, B, n), es)     # rows of the workspace
    if k20_prepass(B, n, mode):
        first = product_tile.lanes_plan(B, n, dname, table, work)
    else:
        lanes = min(copy((m,), (0, st, 1), (1, B, n), es)
                    for m, st in zip((x_mod, r_mod, x2_mod), strides) if m is not None)
        first = product_tile.lanes_plan(B, n, dname, table, lanes, (1, 1, 2, 3)[mode])
    if mode == 0 or k20_fused(n, mode):
        return first, None
    return first, product_tile.lanes_plan(B, n, dname, table, work)


def sine_solve1d_plans(x, S, lam=None, rhs=None, second=None, coeff=None):
    """The two product plans (``sine_solve1d_plan``) a K20 call with these
    operands launches (what chip_smoke prints beside its cases)."""
    B, n = x.shape
    mode = 3 if coeff is not None else 2 if rhs is not None else 1 if lam is not None else 0
    strides = tuple(0 if t is None or B == 1 else t.stride(0) for t in (x, rhs, second))
    mods = tuple(None if t is None else t.data_ptr() & 15 for t in (x, rhs, second, S))
    return sine_solve1d_plan(B, n, x.dtype, mode, (*mods, strides))


def sine_solve1d_pack(index, strides, rows, B, n, mode, plans):
    """The launcher's int64 argument array (csrc/sine_solve1d.cu
    ``launch``): device, twelve pointers (filled in by each call: x, r, x2,
    dt, c2, c1, S, lam, coeff, work, partials, y), the row strides of x, r
    and x2, the output's rows (D, s_hi, s_lo: row b = hi D + lo at hi s_hi
    + lo s_lo), B, n, the mode (0 transform, 1 BE, 2 BE + dt r, 3 BDF2),
    the two products' plans (ten values each; zeros for a transform's
    second), whether a first pass forms the right-hand side
    (``k20_prepass``), the pointer of the rows it writes (filled in by each
    call) and whether one launch runs both products (``k20_fused``)."""
    first, second = plans
    return array.array("q", (index, *(0,) * 12, *strides, *rows, B, n, mode,
                             *first.launch_args(),
                             *(second.launch_args() if second is not None else (0,) * 10),
                             int(k20_prepass(B, n, mode)), 0, int(k20_fused(n, mode))))


@functools.lru_cache(maxsize=1024)
def _solve1d_checked(facts, mods):
    """Every check of a K20 call, on the ``fact``s of its operands (None
    where absent, in ``_K20_KEYS`` order) and, for a CUDA call, the
    operands' offsets from 16-byte alignment (``mods``: x, rhs, second, S),
    cached by them (K20 runs twice a step of every BDF lane: the checks'
    host time is paid once a shape); returns (on the CPU, the launch: the
    argument array without pointers, the launcher, the device index, the
    workspace's size in values and the launch-count key; None on the CPU
    or with nothing to do)."""
    name = "sine_solve1d"
    f = {k: v for k, v in zip(_K20_KEYS, facts) if v is not None}
    _check_facts(name, list(f.values()), list(f).__getitem__)
    dtype, device, xshape, xstride = f["x"]
    if len(xshape) != 2:
        _require(False, name, f"x has shape {tuple(xshape)}, expected (B, n)")
    B, n = xshape
    oshape, ostride = f["out"][2:]
    if not (len(oshape) in (2, 3) and oshape[-1] == n and math.prod(oshape[:-1]) == B):
        _require(False, name, f"out has shape {tuple(oshape)}, expected ({B}, {n}) or "
                              f"(H, D, {n}), H * D = {B}")
    if not (tuple(f["S"][2]) == (n, n) and _contiguous(*f["S"][2:])):
        _require(False, name, f"S must be a contiguous ({n}, {n}) basis")
    has = f.__contains__
    bdf2 = has("coeff")
    if bdf2 and not (has("lam") and not has("dt") and has("rhs") and has("second")
                     and has("c2") and has("c1")):
        _require(False, name, "BDF2 takes lam, rhs, second, c2, c1 and coeff (and no dt)")
    if not bdf2 and (has("second") or has("c2") or has("c1")):
        _require(False, name, "second, c2 and c1 belong to BDF2 (with coeff)")
    if not bdf2 and has("lam") != has("dt"):
        _require(False, name, "lam and dt go together")
    if has("rhs") and not has("lam"):
        _require(False, name, "rhs needs lam and dt")
    lam_rows = 1
    if has("lam"):
        lshape = tuple(f["lam"][2])
        if (len(lshape) == 2 and lshape[1] == n and lshape[0] >= 1 and B % lshape[0] == 0
                and not bdf2):
            lam_rows = lshape[0]
        elif lshape != (n,):
            _require(False, name, f"lam has shape {lshape}, expected ({n},) or, for BE, (D, {n}) "
                                  f"with D dividing {B}")
        if not _contiguous(*f["lam"][2:]):
            _require(False, name, "lam must be contiguous")
    for key in ("dt", "c2", "c1", "coeff"):
        if has(key) and not (tuple(f[key][2]) == (B,) and _contiguous(*f[key][2:])):
            _require(False, name, f"{key} must be a contiguous ({B},) vector")
    for key in ("rhs", "second"):
        if has(key) and tuple(f[key][2]) != (B, n):
            _require(False, name, f"{key} has shape {tuple(f[key][2])}, expected ({B}, {n})")
    if device.type == "cpu" or B == 0 or n == 0:
        return device.type == "cpu", None
    mode = 3 if bdf2 else 2 if has("rhs") else 1 if has("lam") else 0
    strides = tuple(f[k][3][0] if has(k) and B > 1 else 0 for k in ("x", "rhs", "second"))
    rows = (1, ostride[0], 0) if len(oshape) == 2 else (oshape[1], ostride[0], ostride[1])
    plans = sine_solve1d_plan(B, n, dtype, mode, (*mods, strides))
    work_rows = (2 if k20_prepass(B, n, mode) else 0 if k20_fused(n, mode) or not mode
                 else 1)                                          # work [, rhs] rows
    ws = work_rows * B * n + max(p.workspace for p in plans if p is not None)
    args = sine_solve1d_pack(device.index, strides, rows, B, n, mode, plans)
    if lam_rows == 1:
        return False, (args, _launcher("pm_sine_solve1d", dtype), device.index, ws,
                       _K20_MODES[mode])
    table = _launcher("pm_sine_solve1d_lam_rows", dtype)
    return False, (args, lambda addr, stream: table(addr, lam_rows, stream), device.index, ws,
                   _K20_MODES[mode] + " lam table")


_K20_WORK = {}   # (CUDA device index, stream, dtype) -> K20's work rows and partials


def _solve1d_workspace(index, stream, dtype, size):
    """K20's device workspace for launches on ``stream`` of CUDA device
    ``index``: the work rows between a solve's two products (and the rows
    of the right-hand side's first pass), then the split plans' partials;
    grown to at least ``size`` values, kept for later calls."""
    ws = _K20_WORK.get((index, stream, dtype))
    if ws is None or ws.numel() < size:
        ws = _K20_WORK[index, stream, dtype] = torch.empty(
            max(size, 0 if ws is None else 2 * ws.numel()), dtype=dtype,
            device=torch.device("cuda", index))
    return ws


def sine_solve1d(x, out, S, lam=None, dt=None, rhs=None, second=None, c2=None, c1=None,
                 coeff=None):
    """Batched physical Heat1D backward-Euler step (lam and dt given), BDF2
    step (lam, rhs, second, c2, c1 and coeff given) or 1D sine transform
    (none) of B rows of n values (K20).

    x: (B, n) view; out: a (B, n) view, or an (H, D, n) view with H * D = B
    (row b at [b // D, b % D]); S: contiguous (n, n) symmetric basis; lam:
    contiguous (n,) eigenvalues, or for BE a contiguous (D, n) table of
    which row b reads row b % D (D dividing B: the distributed Heat2D
    solve's x-pass, row b a column of a state and lam its Lam[:, j]); dt:
    contiguous (B,)
    step sizes; rhs:
    (B, n) view (row stride 0 for one shared row), added as dt * rhs before
    the BE solve (optional there), or BDF2's right-hand side
    (rhs - c2 x) + c1 second with second a (B, n) view and c2, c1, coeff
    contiguous (B,) per-lane coefficients; BDF2 divides by lam + coeff.  A
    solve may write over its inputs; a transform's out must not share memory
    with x.  Every operand's last axis must be contiguous.  Returns out.
    """
    ops = (x, out, S, lam, dt, rhs, second, c2, c1, coeff)
    mods = (x.data_ptr() & 15, None if rhs is None else rhs.data_ptr() & 15,
            None if second is None else second.data_ptr() & 15, S.data_ptr() & 15) \
        if x.is_cuda else ()
    on_cpu, launch = _solve1d_checked(tuple(None if t is None else fact(t) for t in ops), mods)
    if lam is None and out.untyped_storage().data_ptr() == x.untyped_storage().data_ptr():
        _require(False, "sine_solve1d", "a transform's out shares memory with x")
    if on_cpu:
        return sine_solve1d_plain(x, out, S, lam, dt, rhs, second, c2, c1, coeff)
    if launch is None:
        return out
    tmpl, fn, index, size, mode = launch
    args = tmpl[:]
    for k, t in enumerate((x, rhs, second, dt, c2, c1, S, lam, coeff)):
        if t is not None:
            args[1 + k] = t.data_ptr()
    stream = _build.stream(index)
    if size:
        work = _solve1d_workspace(index, stream, x.dtype, size).data_ptr()
        rows = x.numel() * x.element_size()
        args[10] = work
        args[43] = work + rows if args[42] else 0          # the first pass's rows
        args[11] = work + (rows * (2 if args[42] else 1) if lam is not None else 0)
    args[12] = out.data_ptr()
    _build.check(fn(args.buffer_info()[0], stream), "sine_solve1d")
    sine_solve1d.launches += 1
    sine_solve1d.mode_launches[mode] += 1
    return out


sine_solve1d.launches = 0
sine_solve1d.mode_launches = {"be": 0, "bdf2": 0, "transform": 0,   # launches by mode
                              "be lam table": 0}


# ---------------------------------------------------------------------------
# K23 dd_interval_affine, K24 dd_theta_chain: K1 and K2 in double-double
# ---------------------------------------------------------------------------

# elements of a plain DD expression evaluated at once (its ~20 float32
# temporaries then take ~1.3 GB)
_DD_PLAIN_CHUNK = 1 << 24


def _dd_launcher(name: str):
    return getattr(_build.library(), name)


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


# K23's block (csrc/dd_interval_affine.cu: kC): the coefficients one block
# owns; its interval groups, largest first
K23_C = 512
K23_JB = (4, 2, 1)


def dd_interval_affine_plan(J, R, N, seed_out, sms):
    """(intervals a group JB, blocks along N, groups, the grid's y, seeds
    streamed) of one K23 launch on a card of ``sms`` SMs: J intervals of R
    rows of N DD coefficients, a block K23_C coefficients of a group of JB
    intervals, JB the largest of K23_JB that still gives 8 blocks an SM
    (else 1: more intervals a group left fewer blocks resident, 16 and 8
    ran slower at dd_toms129's shapes).  The seeds are streamed through
    registers where each is read once (R = 1 and no seed_out: the
    condensed C-step), else held in shared memory for the group's rows."""
    stream = R == 1 and not seed_out
    bx = -(-N // K23_C)
    jb = next((b for b in K23_JB if bx * -(-J // b) >= 8 * sms), 1)
    groups = -(-J // jb)
    return jb, bx, groups, min(groups, 65535), int(stream)


def dd_interval_affine_pack(index, strides, r0, R, J, N, plan):
    """The launcher's int64 argument array (csrc/dd_interval_affine.cu
    ``pm_dd_interval_affine``): device, ten pointers (filled in by each
    call: x hi, lo; A hi, lo; G hi, lo; out hi, lo; seed_out hi, lo), the
    strides (x's interval stride, out's interval and row strides,
    seed_out's interval stride), r0, R, J, N and the plan."""
    return array.array("q", (index, *(0,) * 10, *strides, r0, R, J, N, *plan))


# dd_interval_affine's DD operands in the order of their facts
_DD_AFFINE_KEYS = ("x", "A", "G", "out", "seed_out")


@functools.lru_cache(maxsize=1024)
def _dd_interval_checked(facts, r0):
    """Every check of a K23 call, on the ``fact``s of the DD operands' hi
    and lo ((hi, lo) of x, A, G, out and seed_out if given) and r0, cached
    by them (K23 runs at every condensed C-step of a DD solve); returns (on
    the CPU, the launch: the argument array without pointers, the launcher
    and the device index; None on the CPU or with nothing to do)."""
    name = "dd_interval_affine"
    device = facts[0][0][1]
    if device.type not in ("cpu", "cuda"):
        _require(False, name, f"unsupported device {device}")
    for key, (hi, lo) in zip(_DD_AFFINE_KEYS, facts):
        for dtype, dev, _, _ in (hi, lo):
            if dtype != torch.float32:
                _require(False, name, f"{key} must be float32 pairs")
            if dev != device:
                _require(False, name, f"{key} is on {dev}, expected {device}")
        if hi[2:] != lo[2:]:
            _require(False, name, f"{key}: hi and lo must have one shape and one set of strides")
        if len(hi[2]) and hi[2][-1] > 1 and hi[3][-1] != 1:
            _require(False, name, f"{key} must be contiguous in its last axis")
    f = dict(zip(_DD_AFFINE_KEYS, facts))
    xshape, xstride = f["x"][0][2:]
    if len(xshape) != 2:
        _require(False, name, f"x has shape {tuple(xshape)}, expected (J, N)")
    J, N = xshape
    tshape = f["A"][0][2]
    if not (len(tshape) == 2 and f["G"][0][2] == tshape and tshape[1] == N
            and all(_contiguous(*h[2:]) for pair in (f["A"], f["G"]) for h in pair)):
        _require(False, name, "A and G must be contiguous (T, N) DD tables")
    oshape, ostride = f["out"][0][2:]
    if not (len(oshape) == 3 and oshape[0] == J and oshape[2] == N):
        _require(False, name, f"out has shape {tuple(oshape)}, expected ({J}, R, {N})")
    R = oshape[1]
    if not (0 <= r0 and r0 + R <= tshape[0]):
        _require(False, name, f"rows {r0}..{r0 + R - 1} outside the {tshape[0]}-row table")
    if "seed_out" in f and tuple(f["seed_out"][0][2]) != (J, N):
        _require(False, name, "seed_out must have the shape of x")
    if device.type == "cpu" or J * N == 0:
        return device.type == "cpu", None
    strides = (xstride[0], *ostride[:2], f["seed_out"][0][3][0] if "seed_out" in f else 0)
    plan = dd_interval_affine_plan(J, R, N, "seed_out" in f, _build.sm_count(device.index))
    args = dd_interval_affine_pack(device.index, strides, r0, R, J, N, plan)
    return False, (args, _dd_launcher("pm_dd_interval_affine"), device.index)


def dd_interval_affine(x, A, G, out, r0=0, seed_out=None):
    """K1's closed-form interval relaxation in double-double, into ``out``
    (K23).

    x: (J, N) DD seeds; A, G: (T, N) contiguous DD tables; out: (J, R, N) DD
    view with any interval and row strides, rows r0..r0+R-1 of the tables;
    seed_out: optional (J, N) DD view that receives a copy of x.  hi and lo
    of each operand share strides (a packed tube, lo = hi + N, or separate
    tensors).  Returns out.

    The checks, the plan and the packed argument array are cached by the
    operands' facts (``_dd_interval_checked``); a call on the card fills in
    the pointers and makes one ctypes call.
    """
    pairs = (x, A, G, out) if seed_out is None else (x, A, G, out, seed_out)
    try:
        facts = tuple((fact(p.hi), fact(p.lo)) for p in pairs)
    except AttributeError:
        key = next(k for k, p in zip(_DD_AFFINE_KEYS, pairs)
                   if not (hasattr(p, "hi") and hasattr(p, "lo")))
        raise ValueError(f"dd_interval_affine: {key} must be a DD pair") from None
    on_cpu, launch = _dd_interval_checked(facts, int(r0))
    if on_cpu:
        return dd_interval_affine_plain(x, A, G, out, r0, seed_out)
    if launch is None:
        return out
    tmpl, fn, index = launch
    args = tmpl[:]
    args[1], args[2] = x.hi.data_ptr(), x.lo.data_ptr()
    args[3], args[4] = A.hi.data_ptr(), A.lo.data_ptr()
    args[5], args[6] = G.hi.data_ptr(), G.lo.data_ptr()
    args[7], args[8] = out.hi.data_ptr(), out.lo.data_ptr()
    if seed_out is not None:
        args[9], args[10] = seed_out.hi.data_ptr(), seed_out.lo.data_ptr()
    _build.check(fn(args.buffer_info()[0], _build.stream(index)), "dd_interval_affine")
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


# K24's blocks (csrc/dd_theta_chain.cu: kThreads the largest), largest
# first: an item is one chain's segment of a block's threads
K24_THREADS = (256, 128, 64)


def dd_theta_chain_plan(J, N, sms):
    """(threads a block, segments a chain, grid) of one K24 launch on a card
    of ``sms`` SMs: J chains of N DD coefficients, one thread a coefficient,
    one block an item (a chain's segment); the largest block that still
    gives 4 items an SM, else 64 threads."""
    threads = next((t for t in K24_THREADS if J * -(-N // t) >= 4 * sms), K24_THREADS[-1])
    segs = -(-N // threads)
    return threads, segs, max(1, min(J * segs, 2 ** 31 - 1))


def dd_theta_chain_pack(index, strides, J, L, N, cn, has_g, tab, plan):
    """The launcher's int64 argument array (csrc/dd_theta_chain.cu
    ``pm_dd_theta_chain``): device, fourteen pointers (filled in by each
    call: x0 hi, lo; out hi, lo; g hi, lo; dt hi, lo; lam hi, lo; lift hi,
    lo; rhs1; rhs0), the strides (x0's chain stride, out's chain and step
    strides, g's chain and step strides, the rhs rows' step and chain
    strides), J, L, N, segments a chain, grid, CN, g present, rhs
    tabulated, threads a block."""
    threads, segs, grid = plan
    return array.array("q", (index, *(0,) * 14, *strides, J, L, N, segs, grid, int(cn),
                             int(has_g), int(tab), threads))


# dd_theta_chain's DD operands in the order of their facts
_DD_CHAIN_KEYS = ("x0", "out", "dt", "lam", "lift", "g")


@functools.lru_cache(maxsize=1024)
def _dd_chain_checked(facts, rfacts, theta):
    """Every check of a K24 call, on the ``fact``s of the DD operands' hi
    and lo ((hi, lo) of x0, out, dt, lam, lift and g if given), of rhs1 and
    rhs0, and theta, cached by them (K24 runs at every coarse-level F- and
    C-relaxation, FAS residual and coarsest solve of a DD solve); returns
    (on the CPU, the launch: the argument array without pointers, the
    launcher and the device index; None on the CPU or with nothing to
    do)."""
    name = "dd_theta_chain"
    f = dict(zip(_DD_CHAIN_KEYS, facts))
    device = f["x0"][0][1]
    if device.type not in ("cpu", "cuda"):
        _require(False, name, f"unsupported device {device}")
    for key, (hi, lo) in f.items():
        for dtype, dev, _, _ in (hi, lo):
            if dtype != torch.float32:
                _require(False, name, f"{key} must be float32 pairs")
            if dev != device:
                _require(False, name, f"{key} is on {dev}, expected {device}")
        if hi[2:] != lo[2:]:
            _require(False, name, f"{key}: hi and lo must have one shape and one set of strides")
        if len(hi[2]) and hi[2][-1] > 1 and hi[3][-1] != 1:
            _require(False, name, f"{key} must be contiguous in its last axis")
    xshape, xstride = f["x0"][0][2:]
    if len(xshape) != 2:
        _require(False, name, f"x0 has shape {tuple(xshape)}, expected (J, N)")
    J, N = xshape
    oshape, ostride = f["out"][0][2:]
    if not (len(oshape) == 3 and oshape[0] == J and oshape[2] == N):
        _require(False, name, f"out has shape {tuple(oshape)}, expected ({J}, L, {N})")
    L = oshape[1]
    if "g" in f and f["g"][0][2] != oshape:
        _require(False, name, "g must have the shape of out")
    if not (tuple(f["dt"][0][2]) == (L, J) and _contiguous(*f["dt"][0][2:])):
        _require(False, name, f"dt must be a contiguous ({L}, {J}) DD table")
    if not (tuple(f["lam"][0][2]) == (N,) and tuple(f["lift"][0][2]) == (N,)):
        _require(False, name, "lam and lift must have shape (N,)")
    for key, (dtype, dev, shape, stride) in zip(("rhs1", "rhs0"), rfacts):
        if dtype != torch.float32 or dev != device:
            _require(False, name, f"{key} must be a float32 tensor on {device}")
        if len(shape) and shape[-1] > 1 and stride[-1] != 1:
            _require(False, name, f"{key} must be contiguous in its last axis")
    r1, r0 = rfacts
    if not (tuple(r1[2]) == (L, J, N) and r0[2] == r1[2] and r0[3] == r1[3]):
        _require(False, name, "rhs1 and rhs0 must be (L, J, N) views with equal strides")
    if not theta > 0.0:
        _require(False, name, "theta must be > 0 (BE or CN)")
    if device.type == "cpu" or J * L * N == 0:
        return device.type == "cpu", None
    gs = f["g"][0][3][:2] if "g" in f else (0, 0)
    r_sk, r_sj = r1[3][0] if L > 1 else 0, r1[3][1] if J > 1 else 0
    args = dd_theta_chain_pack(device.index, (xstride[0], *ostride[:2], *gs, r_sk, r_sj), J, L,
                               N, theta != 1.0, "g" in f, (r_sk, r_sj) != (0, 0),
                               dd_theta_chain_plan(J, N, _build.sm_count(device.index)))
    return False, (args, _dd_launcher("pm_dd_theta_chain"), device.index)


def dd_theta_chain(x0, out, dt, lam, lift, rhs1, rhs0, theta, g=None):
    """K2's sequential spectral theta-steps of J chains in double-double,
    every step written (K24).

    x0: (J, N) DD seeds; out: (J, L, N) DD view; g: optional (J, L, N) DD
    view added after each step; dt: (L, J) contiguous DD step sizes; lam,
    lift: (N,) DD eigenvalues and lifted boundary data; rhs1, rhs0: (L, J,
    N) float32 views of the rhs at the step's end and start (strides 0 for
    a time-independent rhs; rhs0 is read only when theta != 1); theta: 1
    (BE) or 0.5 (CN).  hi and lo of each DD operand share shape and strides
    (a packed tube, lo = hi + N, or separate tensors), and every operand's
    last axis is contiguous.  out must not overlap x0 or g.  Returns out.

    The checks, the plan and the packed argument array are cached by the
    operands' facts (``_dd_chain_checked``); a call on the card fills in
    the pointers and makes one ctypes call.
    """
    pairs = (x0, out, dt, lam, lift) if g is None else (x0, out, dt, lam, lift, g)
    try:
        facts = tuple((fact(x.hi), fact(x.lo)) for x in pairs)
    except AttributeError:
        key = next(k for k, x in zip(_DD_CHAIN_KEYS, pairs) if not hasattr(x, "lo"))
        raise ValueError(f"dd_theta_chain: {key} must be a DD pair") from None
    theta = float(theta)
    on_cpu, launch = _dd_chain_checked(facts, (fact(rhs1), fact(rhs0)), theta)
    if on_cpu:
        return dd_theta_chain_plain(x0, out, dt, lam, lift, rhs1, rhs0, theta, g)
    if launch is None:
        return out
    tmpl, fn, index = launch
    args = tmpl[:]
    args[1], args[2] = x0.hi.data_ptr(), x0.lo.data_ptr()
    args[3], args[4] = out.hi.data_ptr(), out.lo.data_ptr()
    if g is not None:
        args[5], args[6] = g.hi.data_ptr(), g.lo.data_ptr()
    args[7], args[8] = dt.hi.data_ptr(), dt.lo.data_ptr()
    args[9], args[10] = lam.hi.data_ptr(), lam.lo.data_ptr()
    args[11], args[12] = lift.hi.data_ptr(), lift.lo.data_ptr()
    args[13], args[14] = rhs1.data_ptr(), rhs0.data_ptr()
    _build.check(fn(args.buffer_info()[0], theta, _build.stream(index)), "dd_theta_chain")
    dd_theta_chain.launches += 1
    return out


dd_theta_chain.launches = 0
