"""The highway transition's hand-written CUDA kernel
(``csrc/highway_transition.cu``, ``ops/highway_transition.py``) and the rule
by which ``HighwayEnv.transition`` takes it (``kernel_declines``).

``transition`` has two outcomes: a launch of the kernel
(``env.transition_kernel.launches``) or the eager body
(``env.transition_eager.calls``). On the CPU every form runs the eager body,
and the rule gives each form's reason; the card tests (marker ``card``; they
skip without one) hold the kernel bit for bit against ``_transition_eager``
run eagerly on the card, field by field with dtypes, shapes and aliasing, on
seeded and adversarial scenes, and check that a call of the kernel's form
with tensors it cannot take raises. Run them on the card with
``python -m pytest tests/test_torch_highway_kernel.py -m card -s``."""
import json
import time
from pathlib import Path

import pytest
import torch

from rl_agents_torch.agents.robust.robust import _model_rows
from rl_agents_torch.envs import highway as th
from rl_agents_torch.factory import load_environment
from rl_agents_torch.ops import highway_transition as kernel
from rl_agents_torch.trainer.profiling import counters

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "scripts" / "configs"
HIGHWAY = {"id": "highway", "vehicles_count": 15, "lanes_count": 4, "duration": 40}
ON_THE_CARD = "not all on one CUDA device"
CPU = "CPU tensors"
COUNTED = ("env.transition_kernel.launches", "env.transition_eager.calls")


def _counted(run):
    before = counters.copy()
    out = run()
    delta = counters - before
    own, benchmarks = th.EAGER_COUNTERS  # the benchmark's name counts every eager call too
    assert delta[benchmarks] == delta[own]
    return out, tuple(delta[k] for k in COUNTED)


def _scenes(env, params, rows: int, seed: int = 0, steps: int = 3):
    """``rows`` states from the seed, stepped eagerly a few times with random
    actions so that lanes change and some egos crash."""
    gen = torch.Generator(device=params.dt.device).manual_seed(seed)
    state, _ = env.reset(params, gen, rows)
    for _ in range(steps):
        state = env._transition_eager(params, state, _actions(env, rows, gen)).state
    return state


def _actions(env, rows: int, gen):
    device = gen.device
    if env.action_type == "continuous":
        return torch.rand((rows, 2), generator=gen, device=device) * 2.0 - 1.0
    shape = (rows,) if env.controlled_vehicles == 1 else (rows, env.controlled_vehicles)
    return torch.randint(0, 5, shape, generator=gen, device=device)


def _leaves(out) -> dict:
    """Every output field of a ``StepOut`` by name."""
    fields = {f"state.{k}": v for k, v in out.state._asdict().items()}
    fields.update(obs=out.obs, reward=out.reward, terminated=out.terminated,
                  truncated=out.truncated)
    fields.update({f"info.{k}": v for k, v in out.info.items()})
    return fields


def _assert_same_bits(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for name, value in want.items():
        assert got[name].dtype == value.dtype and got[name].shape == value.shape, name
        assert torch.equal(got[name], value), name  # a tolerance of exactly 0


def _per_row_params(params, rows: int):
    """DROP's form: three behaviour models, one model's params a row."""
    models = [params] + [params._replace(**{k: torch.full_like(getattr(params, k), v)
                                            for k, v in th.BEHAVIOR_PRESETS[name].items()})
                         for name in ("AggressiveVehicle", "DefensiveVehicle")]
    ensemble = type(params)(*(torch.stack(fields) for fields in zip(*models)))
    return _model_rows(ensemble, rows // 3, 1, 3)


# --------------------------------------------------------------------- CPU

@pytest.mark.parametrize("config", [HIGHWAY, {"id": "highway-v0", "controlled_vehicles": 2},
                                    json.loads((CONFIGS / "HighwayEnv" /
                                                "env_continuous.json").read_text())],
                         ids=["meta", "two_egos", "continuous"])
def test_on_the_cpu_every_call_runs_eagerly_and_is_counted(config):
    handle = load_environment(dict(config), device="cpu")
    env, params = handle.functional, handle.params
    state = _scenes(env, params, 6)
    gen = torch.Generator().manual_seed(1)
    action = _actions(env, 6, gen)
    want = env._transition_eager(params, state, action)
    for _ in range(3):
        out, calls = _counted(lambda: env.transition(params, state, action))
        _assert_same_bits(out, want)
        assert calls == (0, 1)


def test_the_overriding_envs_keep_their_own_transition():
    """Two-way's transition is its own body; the intersection's
    ``transition`` is the highway one (the kernel on the card), its ``step``
    its own."""
    assert th.TwoWayEnv.transition is not th.HighwayEnv.transition
    assert th.IntersectionEnv.transition is th.HighwayEnv.transition
    assert th.IntersectionEnv.step is not th.HighwayEnv.step


def _form(name: str, device):
    """(env, params, state, action) of one form of call, on 6 rows."""
    config = {"continuous": json.loads((CONFIGS / "HighwayEnv" /
                                        "env_continuous.json").read_text()),
              "two_egos": {"id": "highway-v0", "controlled_vehicles": 2},
              "two_way": {"id": "two-way-v0"},
              "intersection": {"id": "intersection-v0"},
              "vehicles_33": dict(HIGHWAY, vehicles_count=33)}.get(name, HIGHWAY)
    handle = load_environment(dict(config), device=device)
    env, params = handle.functional, handle.params
    state = _scenes(env, params, 6)
    action = _actions(env, 6, torch.Generator(device=device).manual_seed(1))
    if name == "per_row":
        params = _per_row_params(params, 6)
    if name == "grad":
        state = state._replace(x=state.x.clone().requires_grad_())
    return env, params, state, action


# form: (the rule's reason on the CPU, counted deltas of one call on the CPU,
# what a call on the card does)
FORMS = {
    "meta_one_ego": (CPU, (0, 1), "kernel"),
    "continuous": ("continuous actions", (0, 1), "eager"),
    "two_egos": ("several egos", (0, 1), "eager"),
    "two_way": ("a transition of its own", (0, 0), "own body"),
    "intersection": (CPU, (0, 1), "kernel"),
    "per_row": (CPU, (0, 1), "kernel"),
    "vehicles_33": (CPU, (0, 1), "raises"),
    "grad": ("grad into an input", (0, 1), "eager"),
}


@pytest.mark.parametrize("name", FORMS)
def test_on_the_cpu_each_form_gets_its_reason_and_runs_as_before(name, monkeypatch):
    """Meta-actions of one ego, the intersection's inherited transition and
    per-row params are the kernel's forms: on the CPU only the device stands
    in their way, and a form the kernel cannot take (33 vehicles) runs
    eagerly there too. Every form runs as before, never near the kernel's
    build, and the CPU route equals the eager body bit for bit."""
    def forbidden(*args, **kwargs):
        raise AssertionError("the CPU path reached the CUDA kernel")

    for attr in ("build", "_load", "launch"):
        monkeypatch.setattr(kernel, attr, forbidden)
    reason, calls, _ = FORMS[name]
    env, params, state, action = _form(name, "cpu")
    assert env.kernel_declines(params, state, torch.as_tensor(action)) == reason
    out, delta = _counted(lambda: env.transition(params, state, action))
    assert delta == calls
    if name != "two_way":  # two-way's transition is its own body
        _assert_same_bits(out, env._transition_eager(params, state, action))


def _wrong(form: str, state, action):
    """(state, action) of the kernel's form of call with one input it cannot
    take."""
    if form == "state_dtype":
        return state._replace(speed=state.speed.double()), action
    if form == "state_shape":
        return state._replace(t=state.t[:, None]), action
    if form == "actions":
        return state, action[:-1]
    return state, action


@pytest.mark.parametrize("form, reason", [
    ("well_formed", ON_THE_CARD), ("state_dtype", "state dtypes"), ("state_shape", "state shapes"),
    ("actions", "not one action a row"), ("params", "params form"),
    ("vehicles_33", "a state of shape (6, 33): the kernel takes 1 to 32 vehicles")])
def test_the_tensors_the_kernel_takes(form, reason):
    """``ops/highway_transition.py::declines`` names what the kernel cannot
    take; on the card ``kernel_declines`` raises with that reason, and on the
    CPU tensors the device is all that is left of a well-formed call."""
    env, params, state, action = _form("vehicles_33" if form == "vehicles_33" else "meta_one_ego",
                                       "cpu")
    state, action = _wrong(form, state, torch.as_tensor(action))
    if form == "params":
        params = params._replace(idm_a=params.idm_a.double())
    assert kernel.declines(params, state, action, env.vehicles) == reason


def test_a_params_form_is_worked_out_once_per_object():
    """``_params_form`` keeps its answer for the same object and row count,
    and works it out anew for another object or another row count; a strided
    field is marked for a contiguous copy."""
    handle = load_environment(dict(HIGHWAY), device="cpu")
    params = handle.params
    form = kernel._params_form(params, 6)
    assert form == (0, -1, True) and kernel._params_form(params, 6) is form
    strided = params._replace(target_speeds=torch.tensor([20.0, 0.0, 25.0, 0.0, 30.0, 0.0])[::2])
    assert kernel._params_form(strided, 6) == (0, -1, False)
    per_row = _per_row_params(params, 6)
    assert kernel._params_form(per_row, 6) == ((1 << len(kernel.PARAM_FIELDS)) - 1, -1, True)
    assert kernel._params_form(per_row, 5)[0] is None


@pytest.mark.parametrize("form, mask", [
    ("one_model", 0), ("per_row", (1 << len(kernel.PARAM_FIELDS)) - 1), ("one_row", 0),
    ("other_rows", None), ("vector_width", None), ("float64", None), ("matrix", None)])
def test_the_params_forms_the_kernel_reads(form, mask):
    """``_per_row``: one model's values (0-d, vectors of their width, or a
    leading axis of 1) are read by every row; one a row by its row; any
    other form is declined."""
    handle = load_environment(dict(HIGHWAY), device="cpu")
    params, rows = handle.params, 6
    if form == "per_row":
        params = _per_row_params(params, rows)
    elif form == "one_row":
        params = params._replace(idm_a=params.idm_a[None], target_speeds=params.target_speeds[None])
    elif form == "other_rows":
        params = params._replace(idm_a=params.idm_a.repeat(rows - 1))
    elif form == "vector_width":
        params = params._replace(target_speeds=torch.tensor([20.0, 25.0, 30.0, 35.0]))
    elif form == "float64":
        params = params._replace(dt=params.dt.double())
    elif form == "matrix":
        params = params._replace(idm_b=params.idm_b.expand(rows, 2))
    assert kernel._per_row(kernel._fields(params), rows) == mask


def test_the_outputs_of_the_kernel_keep_the_eager_layout():
    """``launch``'s output buffers give the eager's fields, shapes, dtypes and
    aliasing (the values are the card tests')."""
    handle = load_environment(dict(HIGHWAY), device="cpu")
    env, params = handle.functional, handle.params
    state = _scenes(env, params, 5)
    want = env._transition_eager(params, state, torch.zeros(5, dtype=torch.int64))
    _, got = kernel._outputs(state, 5, 15)
    got_leaves, want_leaves = _leaves(got), _leaves(want)
    assert got_leaves.keys() == want_leaves.keys()
    for name, value in want_leaves.items():
        assert (got_leaves[name].shape, got_leaves[name].dtype) == (value.shape, value.dtype), name
    assert got.state.alive is state.alive and want.state.alive is state.alive
    assert got.terminated is got.state.crashed and got.info["crashed"] is got.state.crashed
    assert want.terminated is want.state.crashed and want.info["crashed"] is want.state.crashed


# -------------------------------------------------------------------- card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _kernel_against_eager(env, params, state, action):
    """One kernel launch equal to the eager body bit for bit, with the eager's
    aliasing; returns the kernel's output."""
    assert env.kernel_declines(params, state, action) is None
    out, delta = _counted(lambda: env.transition(params, state, action))
    assert delta == (1, 0)
    _assert_same_bits(out, env._transition_eager(params, state, action))
    assert out.state.alive is state.alive
    assert out.terminated is out.state.crashed and out.info["crashed"] is out.state.crashed
    return out


@pytest.mark.card
@pytest.mark.parametrize("rows", [1, 5, 4096, 20480])
def test_seeded_scenes_give_the_eager_bits(rows):
    dev = _card()
    handle = load_environment(dict(HIGHWAY), device=dev)
    env, params = handle.functional, handle.params
    for seed in range(3):
        state = _scenes(env, params, rows, seed=seed, steps=2 + 2 * seed)
        action = _actions(env, rows, torch.Generator(device=dev).manual_seed(7 + seed))
        _kernel_against_eager(env, params, state, action)


@pytest.mark.card
@pytest.mark.parametrize("vehicles", [1, 5, 8, 15, 16, 17, kernel.MAX_VEHICLES])
def test_every_vehicle_count_gives_the_eager_bits(vehicles):
    dev = _card()
    handle = load_environment(dict(HIGHWAY, vehicles_count=vehicles), device=dev)
    env, params = handle.functional, handle.params
    state = _scenes(env, params, 777, seed=vehicles)
    _kernel_against_eager(env, params, state,
                          _actions(env, 777, torch.Generator(device=dev).manual_seed(3)))


def _adversarial(env, rows: int, seed: int, device):
    """Scenes built to hit every branch: x on a coarse grid and lanes near
    each other (ties of 2, 3 and more in the neighbour queries, and movers
    into one gap), lanes from -1 to L (candidates off the road), dead
    vehicles, crashed rows, speeds beyond [0, 40] and some tiny ones (so that
    the order of a tie's sum matters), every speed level with every action,
    and step counts at the episode's end."""
    V, L = env.vehicles, env.lanes
    gen = torch.Generator(device=device).manual_seed(seed)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def integers(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device)

    x = 7.5 * integers(0, 6, rows, V).float()
    lane_int = integers(0, L, rows, V)
    lane = lane_int.float() + torch.where(uniform(rows, V) < 0.3,
                                          (uniform(rows, V) - 0.5) * 0.9, 0.0)
    target_lane = torch.where(uniform(rows, V) < 0.8, lane_int, integers(-1, L + 1, rows, V))
    tiny = uniform(rows, V) * 2.0 ** -integers(10, 30, rows, V)
    speed = torch.where(uniform(rows, V) < 0.2, tiny, uniform(rows, V) * 60.0 - 10.0)
    level = integers(0, 3, rows)
    action = integers(0, 5, rows)
    level[:15], action[:15] = torch.arange(15, device=device) // 5, torch.arange(15, device=device) % 5
    alive = uniform(rows, V) < 0.85
    crashed = uniform(rows) < 0.2
    t = integers(env.max_episode_steps - 3, env.max_episode_steps + 1, rows)
    state = th.HighwayState(x=x, lane=lane, target_lane=target_lane, speed=speed,
                            speed_level=level, alive=alive, crashed=crashed, t=t)
    return state, action


def _order_matters(env, state) -> int:
    """How many neighbour queries of the scenes have a tie whose speeds' sum
    differs between the eager's reduction and a sum in the other order: the
    cases where the kernel must follow the eager's order."""
    differs = 0
    for shift in (0.0, -1.0, 1.0):
        own = state.lane + shift
        xi, xj = state.x[:, :, None], state.x[:, None, :]
        same = (state.lane[:, None, :] - own[:, :, None]).abs() < 0.5
        pair = state.alive[:, None, :] & state.alive[:, :, None]
        for ahead in (True, False):
            mask = ((xj > xi) if ahead else (xj < xi)) & same & pair
            gap = torch.where(mask, (xj - xi).abs(), torch.inf)
            near = mask & (gap <= gap.amin(dim=2, keepdim=True))
            terms = torch.where(near, state.speed[:, None, :], 0.0)
            flipped = torch.zeros_like(terms[:, :, 0])
            for j in reversed(range(terms.shape[2])):
                flipped = flipped + terms[:, :, j]
            differs += int((terms.sum(dim=2) != flipped).sum())
    return differs


@pytest.mark.card
@pytest.mark.parametrize("vehicles", [5, 15, kernel.MAX_VEHICLES])
def test_adversarial_scenes_give_the_eager_bits(vehicles):
    dev = _card()
    handle = load_environment(dict(HIGHWAY, vehicles_count=vehicles), device=dev)
    env, params = handle.functional, handle.params
    state, action = _adversarial(env, 4096, seed=vehicles, device=dev)
    assert _order_matters(env, state) > 0
    out = _kernel_against_eager(env, params, state, action)
    # the branches were hit: traffic changed lanes, speeds clamped, rows frozen and truncated
    moved = out.state.target_lane[:, 1:] != state.target_lane[:, 1:].clamp(0, env.lanes - 1)
    assert bool(moved.any())
    running = out.state.speed[~state.crashed]
    assert bool((running == 0.0).any()) and bool((running == 40.0).any())
    assert bool(out.truncated.any()) and bool((out.reward[state.crashed] == 0.0).all())


@pytest.mark.card
def test_two_movers_into_one_gap_give_the_eager_bits():
    """Two traffic vehicles on lanes 0 and 2, each behind a slow leader with
    lane 1 free: both want lane 1, and the rear one is suppressed."""
    dev = _card()
    handle = load_environment(dict(HIGHWAY, vehicles_count=5), device=dev)
    env, params = handle.functional, handle.params
    f32 = dict(dtype=torch.float32, device=dev)
    x = torch.tensor([[-80.0, 0.0, 3.0, 20.0, 23.0]], **f32)
    lane = torch.tensor([[3.0, 0.0, 2.0, 0.0, 2.0]], **f32)
    speed = torch.tensor([[25.0, 30.0, 30.0, 5.0, 5.0]], **f32)
    state = th.HighwayState(x=x, lane=lane, target_lane=lane.long(), speed=speed,
                            speed_level=torch.ones(1, dtype=torch.int64, device=dev),
                            alive=torch.ones((1, 5), dtype=torch.bool, device=dev),
                            crashed=torch.zeros(1, dtype=torch.bool, device=dev),
                            t=torch.zeros(1, dtype=torch.int64, device=dev))
    action = torch.tensor([1], device=dev)
    out = _kernel_against_eager(env, params, state, action)
    assert out.state.target_lane[0, 1:3].tolist() == [0, 1]  # the front mover goes, the rear waits


@pytest.mark.card
def test_the_intersection_and_per_row_params_give_the_eager_bits():
    dev = _card()
    handle = load_environment({"id": "intersection-v0"}, device=dev)
    env, params = handle.functional, handle.params
    state = _scenes(env, params, 512)
    _kernel_against_eager(env, params, state,
                          _actions(env, 512, torch.Generator(device=dev).manual_seed(2)))

    handle = load_environment(dict(HIGHWAY), device=dev)
    env, params = handle.functional, handle.params
    rows = 64 * 5 * 3
    state = _scenes(env, params, rows)
    action = _actions(env, rows, torch.Generator(device=dev).manual_seed(4))
    _kernel_against_eager(env, _per_row_params(params, rows), state, action)


@pytest.mark.card
def test_inside_a_users_capture_the_kernel_is_captured():
    """A user's graph (the fused actor-learner's) captures the launch; its
    replays read the static inputs anew each time."""
    dev = _card()
    handle = load_environment(dict(HIGHWAY), device=dev)
    env, params = handle.functional, handle.params
    gen = torch.Generator(device=dev).manual_seed(5)
    static_state = _scenes(env, params, 128)
    static_action = _actions(env, 128, gen)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # build and load the library outside the capture
        env.transition(params, static_state, static_action)
    torch.cuda.current_stream(dev).wait_stream(side)
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer):
        out, delta = _counted(lambda: env.transition(params, static_state, static_action))
    assert delta == (1, 0)
    for k in range(3):
        next_state = _scenes(env, params, 128, seed=10 + k)
        next_action = _actions(env, 128, gen)
        for dst, src in zip(static_state, next_state):
            dst.copy_(src)
        static_action.copy_(next_action)
        outer.replay()
        _assert_same_bits(out, env._transition_eager(params, next_state, next_action))


@pytest.mark.card
@pytest.mark.parametrize("name", FORMS)
def test_on_the_card_each_form_takes_its_path(name):
    """The forms the kernel takes launch it; the other forms run the eager
    body, two-way its own; a call of the kernel's form with more vehicles
    than it takes raises."""
    dev = _card()
    env, params, state, action = _form(name, dev)
    _, calls, path = FORMS[name]
    if path == "raises":
        with pytest.raises(ValueError, match="the kernel takes 1 to 32 vehicles"):
            env.transition(params, state, action)
    else:
        assert (env.kernel_declines(params, state, action) is None) == (path == "kernel")
        _, delta = _counted(lambda: env.transition(params, state, action))
        assert delta == ((1, 0) if path == "kernel" else calls)
    # CPU tensors on a machine with a card still run eagerly
    env, params, state, action = _form("meta_one_ego", "cpu")
    assert env.kernel_declines(params, state, action) == CPU
    assert _counted(lambda: env.transition(params, state, action))[1] == (0, 1)


@pytest.mark.card
def test_wrong_inputs_on_the_card_raise_and_strided_params_are_read_right():
    """A call of the kernel's form that it cannot take raises with the
    reason instead of running plain PyTorch on the card; a one-model params
    field that is a strided view or an expand gives the eager bits."""
    dev = _card()
    env, params, state, action = _form("meta_one_ego", dev)
    for form in ("state_dtype", "state_shape", "actions"):
        wrong_state, wrong_action = _wrong(form, state, action)
        with pytest.raises(ValueError, match="the highway transition kernel cannot take"):
            env.transition(params, wrong_state, wrong_action)
    with pytest.raises(ValueError, match="params form"):
        env.transition(params._replace(idm_a=params.idm_a.double()), state, action)
    with pytest.raises(ValueError, match="not all on one CUDA device"):
        env.transition(params._replace(idm_a=params.idm_a.cpu()), state, action)
    wide = torch.stack([params.speed_reward_range,
                        torch.zeros_like(params.speed_reward_range)], 1)
    strided = params._replace(speed_reward_range=wide[:, 0],
                              target_speeds=params.target_speeds[1:2].expand(3))
    assert not strided.speed_reward_range.is_contiguous()
    assert strided.target_speeds.stride() == (0,)
    state = _scenes(env, params, 256)
    _kernel_against_eager(env, strided, state,
                          _actions(env, 256, torch.Generator(device=dev).manual_seed(6)))


def _device_ms(call, dev, n: int = 50) -> float:
    """Device time a call: ``n`` calls captured in one CUDA graph and
    replayed between two CUDA events, so that the host's enqueue is not in
    it."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            call()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / n


def _host_us(call, dev, n: int = 200) -> float:
    """Host time a call: the wall clock over ``n`` calls, no synchronise inside."""
    torch.cuda.synchronize(dev)
    started = time.perf_counter()
    for _ in range(n):
        call()
    elapsed = time.perf_counter() - started
    torch.cuda.synchronize(dev)
    return elapsed / n * 1e6


@pytest.mark.card
def test_time_a_launch():
    """The kernel's device time a launch and host time a call, beside the
    eager body's ~314 kernels, its plain version, at the cells' rows;
    printed for PERF.md with the share of perfbench/counts/highway.py's
    bound (67 TFLOP/s float32, 3.35 TB/s), then the host time of a call's
    parts: the rule, the launch, and in it the outputs' allocation and
    views."""
    from perfbench.counts.highway import transition_bytes, transition_ops

    dev = _card()
    handle = load_environment(dict(HIGHWAY), device=dev)
    env, params = handle.functional, handle.params
    print(torch.cuda.get_device_name(dev))
    for rows in (5, 4096, 20480):
        state = _scenes(env, params, rows)
        action = _actions(env, rows, torch.Generator(device=dev).manual_seed(1))
        bound_ms = max(transition_ops(rows, 15) / 67e12, transition_bytes(rows, 15) / 3.35e12) * 1e3
        paths = {"kernel": lambda: env.transition(params, state, action),
                 "eager": lambda: env._transition_eager(params, state, action)}
        for path, call in paths.items():
            for _ in range(3):  # the build and the first calls' allocations
                call()
            device_ms = _device_ms(call, dev)
            host_us = _host_us(call, dev)
            print(f"{path} rows {rows}: {device_ms!r} ms a call on the device, {host_us!r} us "
                  f"of host time a call; bound {bound_ms!r} ms, {100 * bound_ms / device_ms!r}%")
            assert device_ms > 0
        parts = {"kernel_declines": lambda: env.kernel_declines(params, state, action),
                 "launch": lambda: kernel.launch(params, state, action, env.lanes,
                                                 env.max_episode_steps, th._INV_TRAFFIC_SPEED),
                 "_outputs": lambda: kernel._outputs(state, rows, env.vehicles),
                 "torch.empty": lambda: torch.empty(1024, dtype=torch.uint8, device=dev)}
        for part, call in parts.items():
            call()
            print(f"  host rows {rows} {part}: {_host_us(call, dev, 1000)!r} us a call")
