"""Seeded inputs of the fleet's velocity stage
(``planner/velplan.velocity_stage_scenario``) for the glue kernels of
``ops/cuda_velstage``, and the comparison of a recorded kernel call with
its plain version.

A case is N scenarios of four paths of P points: ragged batches and
lengths around the velocity scan's 16-step chunk and the fleet's 448,
paths ending anywhere (down to one valid point), straights, committed
courses of 0-8 points, planned velocities above and below ``vel_max``
(the brake prefix active and not), reduced horizons, follow gaps from
inside the safety distance to far ahead (so ``stop_idx`` below 2 and the
ego brake that cannot hold both occur), and the opponent's run-out before
and beyond its raceline window.  The arguments are those of
``velocity_stage_scenario`` with the constant local gg (``const_gg``), as
the fleet tick gives them.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from graphbasedlocaltrajectoryplanner_torch.ops import cuda_graph
from graphbasedlocaltrajectoryplanner_torch.ops import cuda_velstage as vs

K = 4
F_CAP = 128
# (N, P, follow slot)
CASES = ((1, 17, 1), (5, 18, 1), (33, 16, 3), (5, 3, 1), (33, 449, 0),
         (5, 447, 2), (1000, 448, 1))
VEL_MAX = 70.0
MACHINES = ((0.0, 5.0), (30.0, 4.0), (70.0, 2.0))


def stage_case(N: int, P: int, fs: int, seed: int, device="cpu",
               backend: str = "fb"):
    """``(args, kwargs)`` of ``velocity_stage_scenario`` for a seeded
    case of N scenarios of four P-point paths (module docstring)."""
    rng = np.random.default_rng(seed)
    idx = np.arange(P)
    n_valid = rng.integers(1, P + 1, (N, K))
    n_valid[rng.random((N, K)) < 0.5] = P
    el = rng.uniform(0.5, 3.0, (N, K, P))
    el[idx >= n_valid[..., None] - 1] = 0.0
    kappa = rng.normal(0.0, 0.02, (N, K, P))
    kappa[rng.random((N, K, P)) < 0.1] = 0.0
    xy = np.cumsum(rng.normal(0.0, 2.0, (N, K, P, 2)), axis=2)
    psi = rng.uniform(-np.pi, np.pi, (N, K, P))
    paths = np.concatenate([xy, psi[..., None], kappa[..., None],
                            el[..., None]], axis=-1)
    c_len = rng.integers(0, min(P - 1, 8) + 1, N)
    vel_plan = rng.uniform(5.0, 90.0, N)
    vel_course = rng.uniform(0.0, 70.0, (N, P))
    v_end_rl = rng.uniform(5.0, 40.0, (N, K))
    red_len = rng.random((N, K)) < 0.3
    obj_dist = rng.uniform(-10.0, 160.0, N)
    v_obj = rng.uniform(0.0, 60.0, N)
    opp_stop_dist = rng.uniform(0.0, 250.0, N)
    roll_el = rng.uniform(0.5, 3.0, (N, F_CAP))
    roll_cum = np.cumsum(roll_el, axis=1)
    roll_vel = rng.uniform(10.0, 70.0, (N, F_CAP))
    vel_est = vel_plan + rng.normal(0.0, 2.0, N)
    ay = float(rng.choice([10.0, 8.0]))

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    def f32(x):
        return cuda_graph.as_tensor(float(x), torch.float32, device)
    gg = cuda_graph.const_vector([10.0, ay], torch.float32,
                                 device).expand(P, 2)
    args = (t(paths), t(n_valid, torch.int64), gg, t(vel_course),
            t(c_len, torch.int64), t(vel_plan), t(vel_est), f32(VEL_MAX),
            t(MACHINES), f32(0.1), t(v_end_rl), t(red_len, torch.bool),
            t(obj_dist), t(v_obj), f32(30.0), t(opp_stop_dist), t(roll_vel),
            t(roll_cum), f32(4.7), f32(1.25), f32(0.025), f32(0.2),
            f32(15.0), 1.0, 0.85, 1000.0)
    kw = dict(follow_slot=fs, const_gg=(10.0, ay), vp_backend=backend)
    if backend == "sqp":
        kw.update(tire_end_idx=2, tire_end_mps2=f32(10.0), sqp_m=min(P, 115),
                  sqp_step=2.5, veh_turn=f32(7.0))
    return args, kw


def route(args, kw):
    """The kernel route of ``velocity_stage_scenario``'s fb branch on the
    stage's arguments ``(args, kw)``: ``velplan._fb_kernels`` (on CPU
    tensors every wrapper is its plain version).  Returns (trajs,
    vel_bound, too_close)."""
    from graphbasedlocaltrajectoryplanner_torch.planner import velplan
    (paths, n_valids, gg, vel_course, c_len, vel_plan, vel_est, vel_max,
     machines, v_max_offset, v_end_rl, red_len, obj_dist, v_obj, safety_d,
     opp_stop_dist, roll_vel, roll_cum, veh_length, ctrl_cp, ctrl_kd,
     ctrl_kp, ctrl_tanw, exp, drag, m_veh) = args
    s4 = kw.get("s4")
    if s4 is None:
        s4 = velplan._cumsum0(paths[..., 4])
    _, v_control = velplan._follow_control(
        ctrl_cp, ctrl_kd, ctrl_kp, ctrl_tanw, safety_d, veh_length, obj_dist,
        v_obj, vel_est, vel_max, kw.get("control_type", "PD"))
    scan = velplan._scan(kw["const_gg"], machines, exp, drag, m_veh, True)
    return velplan._fb_kernels(
        paths, s4, n_valids, red_len, v_end_rl, c_len.long(), vel_plan,
        vel_max, gg[:, 1], v_control, obj_dist, safety_d, veh_length,
        opp_stop_dist, roll_vel, roll_cum, kw.get("follow_slot", 1),
        vel_course, v_max_offset, scan)


def stage_calls(fn):
    """``fn()`` with the arguments of every ``velocity_stage_scenario``
    call it makes recorded: ``[(args, kwargs)]``."""
    from graphbasedlocaltrajectoryplanner_torch.planner import velplan
    calls, orig = [], velplan.velocity_stage_scenario

    def rec(*a, **kw):
        calls.append((a, dict(kw)))
        return orig(*a, **kw)
    velplan.velocity_stage_scenario = rec
    try:
        fn()
    finally:
        velplan.velocity_stage_scenario = orig
    return calls


def _clone(x):
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(y) for y in x)
    return x


def recorded(fn):
    """``fn()`` with every call of ``cuda_velstage.fb_level`` and
    ``cuda_velstage.epilogue`` recorded (arguments cloned, the calls'
    ``launches`` kept on the wrappers): ``(out, {name: [(args, kw)]})``
    with the names of ``cuda_build.KERNEL_WRAPPERS``."""
    calls = {"vel_stage_level": [], "vel_stage_epilogue": []}
    saved = []
    for name, attr in (("vel_stage_level", "fb_level"),
                       ("vel_stage_epilogue", "epilogue")):
        orig = getattr(vs, attr)

        def rec(*a, _orig=orig, _calls=calls[name], **kw):
            _calls.append((_clone(list(a)), _clone(kw)))
            return _orig(*a, **kw)
        rec.launches = 0
        saved.append((attr, orig))
        setattr(vs, attr, rec)
    try:
        out = fn()
    finally:
        for attr, orig in saved:
            n = getattr(vs, attr).launches
            setattr(vs, attr, orig)
            orig.launches += n
    return out, calls


EGO = vs.FOLLOW_STATE.index("ego_stop_d") + 6     # in a level-2 output


def compare(name: str, a, kw, got, want):
    """A recorded call's kernel outputs ``got`` against its plain version's
    ``want``: ``(ok, what, ego)``.  Every output equal (``torch.equal``,
    shapes and dtypes too), but a level-2 call's ``ego_stop_d``, which must
    lie within ``cuda_velstage.stop_distance_bound`` of the plain sum;
    ``ego`` is then (largest |difference| m, its largest share of the
    bound), else None."""
    ego = None
    for i, (x, y) in enumerate(zip(got, want)):
        if x.shape != y.shape or x.dtype != y.dtype:
            return False, f"output {i}: {x.dtype}{tuple(x.shape)} against " \
                f"{y.dtype}{tuple(y.shape)}", ego
        if name == "vel_stage_level" and a[0] == 2 and i == EGO:
            b = inspect.signature(vs.fb_level_plain).bind(*a, **kw).arguments
            paths, fs = b["paths"], b["fs"]
            pref = b["slots"][0][:, fs]
            P = paths.shape[2]
            el = paths[:, fs, :, 4]
            el_m = torch.where(torch.arange(P, device=el.device)
                               < pref[:, None], 0.0, el)
            bound = vs.stop_distance_bound(el_m.abs().sum(-1).double(), P)
            d = (x.double() - y.double()).abs()
            ego = (float(d.max()) if d.numel() else 0.0,
                   float((d / bound.clamp(min=1e-30)).max())
                   if d.numel() else 0.0)
            if not bool((d <= bound).all()):
                return False, f"ego_stop_d beyond its bound by " \
                    f"{float((d - bound).max())} m", ego
            continue
        if not torch.equal(x, y):
            return False, f"output {i} differs in {int((x != y).sum())} " \
                f"of {x.numel()} places", ego
        if x.dtype == torch.float32 and not torch.equal(
                x.contiguous().view(torch.int32),
                y.contiguous().view(torch.int32)):
            return False, f"output {i}: equal values, other bits (a " \
                f"signed zero)", ego
    return True, "", ego


# float operations a written element: a level's row step (masks, the
# lateral bound's division and root, the minima), an epilogue's point (the
# select, the acceleration's products, division and stationary rule)
LEVEL_OPS, EPILOGUE_OPS = 12, 20
# the inputs each launch reads whole (beside the paths' columns)
_READS = {
    0: ("c_len", "vel_plan"),
    1: ("s", "n_valid", "red_len", "v_end_rl", "c_len", "vel_plan",
        "vel_max", "ay", "lv"),
    2: ("n_valid", "red_len", "v_end_rl", "vel_max", "ay", "v_control",
        "obj_dist", "safety_d", "veh_length", "opp_stop_dist", "roll_cum",
        "lv", "s_f", "slots"),
    3: ("slots",),
    "epilogue": ("s", "n_valid", "c_len", "vel_course", "red_len",
                 "v_max_offset", "v_idx", "pref_idx", "vel_start", "lv0",
                 "lv2", "lv3", "vx_normal", "vx_follow", "follow_bound",
                 "follow"),
}


def _held_bytes(v):
    """Bytes of the values a tensor (or a tuple of them) holds: a
    broadcast axis counts once."""
    if isinstance(v, tuple):
        return sum(_held_bytes(y) for y in v)
    if not torch.is_tensor(v):
        return 0
    held = [d for d, st in zip(v.shape, v.stride()) if st]
    return int(np.prod(held)) * v.element_size()


def work(name: str, a, kw, out):
    """(bytes, operations) one recorded call needs: each output written
    once (k2 where it is not k1), each input value read once (a level's
    curvature and element length of the paths it reads, the epilogue's
    five columns; of the level-2 launch the follow path's two arc lengths
    and the opponent's two raceline velocities it gathers, of level 3 the
    follow rows of the paths and of level 2's profiles, of the epilogue the
    ego-brake row of level 1's), operations a written row element or
    point."""
    b = inspect.signature(vs.fb_level_plain if name == "vel_stage_level"
                          else vs.epilogue_plain).bind(*a, **kw).arguments
    out = list(out)
    if name == "vel_stage_level" and out[1] is out[0]:
        out.pop(1)
    nb = sum(x.numel() * x.element_size() for x in out)
    N, k, P = b["paths"].shape[:3]
    key = b["level"] if name == "vel_stage_level" else "epilogue"
    nb += sum(_held_bytes(b.get(n)) for n in _READS[key])
    if key == "epilogue":
        nb += N * k * P * 5 * 4
        if b.get("lv1") is not None:
            nb += N * P * 4
        return nb, N * k * P * EPILOGUE_OPS
    if key == 2:
        nb += N * 4 * 4
    if key == 3:
        nb += N * P * 2 * 4 + N * P * 4 + N * 2 * 8
    else:
        nb += N * k * P * 2 * 4
    return nb, out[0].numel() * LEVEL_OPS


def plain_of(name: str):
    """The plain version of a recorded wrapper."""
    return vs.fb_level_plain if name == "vel_stage_level" \
        else vs.epilogue_plain


def kernel_of(name: str):
    return vs.fb_level if name == "vel_stage_level" else vs.epilogue
