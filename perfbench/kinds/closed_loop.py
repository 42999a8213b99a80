"""Traffic kind ``closed_loop``: the port's policy-in-the-loop fleet
(``training.closed_loop.make_rollout``), every timed call one
``rollout_fn(carry, chunk_steps)`` over the whole fleet.

Traffic keys: ``n_envs``, ``chunk_steps``, ``frame_skip``, ``town``
(``make_town`` arguments), ``sim`` (``SimParams``), ``render``
(``RenderConfig``: height, width, max_triangles, lod_px), ``warm_calls``,
``trace_calls``, ``sample_envs`` (envs the check follows).

The check follows ``sample_envs`` envs drawn from the seed through one
timed call drawn from the seed (one of the first three), from the
program's own state at the call's start, with the plain reference
(``reference/closed_loop.py``): the reference renders each step's frame
from its state, builds its own window, runs the float32 policy, takes the
action the program took, and steps its own simulator. Its start is checked
apart: ``init_fn``'s states and first frames against the reference's reset
from the same draws. The check returns these numbers; a cell compares
those its ``limits/<cell>.json`` names:

- ``frame_off_share``: the share of the program's frame pixels more than
  2/255 from the reference's;
- ``logit_gap_max``: the widest gap by which the logit of the action the
  program took lies below the reference's best logit, the reference's
  float32 policy run on the program's own windows (rebuilt from the
  program's frames, which ``frame_off_share`` judges), every followed env
  at every step;
- ``logit_err_max``: on the same windows, the largest |program logit −
  reference logit| over the actions, as a share of the reference's spread
  of logits (largest − smallest) at that env-step;
- ``diverged_share``: the share of followed envs whose step outcome (done,
  collision, off-road, route, step count) or integer state differs from
  the reference's at some step; a diverged env is compared no further;
- ``state_gap_max``: the largest |program − reference| / (1 + |reference|)
  over the float state fields and the speeds of the envs that did not
  diverge.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.kinds import policy as policy_lib

FLOAT_FIELDS = ("ego_pos", "ego_yaw", "ego_v", "ego_steer", "ego_s", "agents_s", "agents_v")
INT_FIELDS = ("ego_route", "agents_route", "t", "rng", "goal")
TRAJ_KEYS = ("gray", "action", "done", "collision", "offroad", "speed")
FAULTS = ("state_unchanged", "half_batch", "answer_altered")


def _rows(state, rows):
    return dataclasses.replace(state, **{f.name: getattr(state, f.name)[rows]
                                         for f in dataclasses.fields(state)})


def _to(state, dev):
    return dataclasses.replace(state, **{f.name: getattr(state, f.name).to(dev)
                                         for f in dataclasses.fields(state)})


def _plant(fault: str | None, policy_fn):
    """Plant one of the correctness check's test faults in the port's closed loop: the sim
    step returns its state unchanged, or steps only the first half of the
    fleet; or the action is altered where the policy produces it. → (the
    policy to drive with, a function that takes the fault out again)."""
    if fault is None:
        return policy_fn, lambda: None
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if fault == "answer_altered":   # every 4th env's logits rolled by one action
        from carla_imitation_learning_tpu_torch.models import PolicyCNN, ViTPolicy

        real_fwd = {cls: cls.forward for cls in (PolicyCNN, ViTPolicy)}

        def altered(cls):
            def forward(self, x):
                out = real_fwd[cls](self, x)
                every4 = torch.arange(out.shape[0], device=out.device)[:, None] % 4 == 0
                return torch.where(every4, out.roll(1, -1), out)
            return forward

        for cls in real_fwd:
            cls.forward = altered(cls)

        def restore_forward():
            for cls, fwd in real_fwd.items():
                cls.forward = fwd

        return policy_fn, restore_forward
    from carla_imitation_learning_tpu_torch.training import closed_loop

    real = closed_loop.step_env

    def broken(params, town, states, control, fresh):
        new, info = real(params, town, states, control, fresh)
        if fault == "state_unchanged":
            return states, info
        half = torch.arange(states.t.shape[0], device=states.t.device) < states.t.shape[0] // 2
        return dataclasses.replace(new, **{
            f.name: torch.where(half.view((-1,) + (1,) * (getattr(new, f.name).dim() - 1)),
                                getattr(new, f.name), getattr(states, f.name))
            for f in dataclasses.fields(new)}), info

    closed_loop.step_env = broken

    def restore():
        closed_loop.step_env = real

    return policy_fn, restore


class ClosedLoop:
    rate_metric = "env_steps_per_s"

    def __init__(self, cfg, traffic, seed, dev, fault=None):
        from carla_imitation_learning_tpu_torch.render.pipeline import RenderConfig
        from carla_imitation_learning_tpu_torch.sim.town import make_town
        from carla_imitation_learning_tpu_torch.sim.world import SimParams
        from carla_imitation_learning_tpu_torch.training.closed_loop import make_rollout

        self.t, self.seed, self.dev = traffic, seed, dev
        self.n_envs, self.chunk = traffic["n_envs"], traffic["chunk_steps"]
        self.model, self.weights, self.reference = policy_lib.build(cfg, seed, dev)
        self.model.eval()
        model, self.kept_logits = self.model, None

        def policy_fn(obs):
            logits = model(obs)
            if self.kept_logits is not None:
                self.kept_logits.append(logits[self.rows].float())
            return logits.argmax(-1)

        params = SimParams(**traffic["sim"])
        town = make_town(**traffic["town"]).to(dev)
        rcfg = RenderConfig(**traffic["render"], rgb=False, fast=True)
        driver, self.unplant = _plant(fault, policy_fn)
        init_fn, self.rollout_fn = make_rollout(params, town, rcfg, driver,
                                                traffic["frame_skip"], device=dev)
        self.carry = init_fn(torch.Generator().manual_seed(seed), self.n_envs)
        rng = np.random.default_rng(seed)
        n_sample = min(traffic["sample_envs"], self.n_envs)
        self.rows = torch.as_tensor(np.sort(rng.choice(self.n_envs, n_sample, replace=False)),
                                    device=dev)
        self.sample_call = int(rng.integers(0, min(3, traffic["trace_calls"])))
        self.min_calls = self.sample_call + 1
        self.start = (_rows(self.carry[0], self.rows), self.carry[1][self.rows])
        hw = (traffic["render"]["height"], traffic["render"]["width"])
        self.flops_per_env_step = policy_lib.flops(
            model, (self.n_envs,) + hw + (traffic["frame_skip"],), backward=False) / self.n_envs
        for _ in range(traffic["warm_calls"]):
            self.carry, _ = self.rollout_fn(self.carry, self.chunk)
        self.calls, self.sampled, self.stats = 0, None, {}

    def call(self) -> int:
        take = self.calls == self.sample_call
        if take:
            carry_in = (_rows(self.carry[0], self.rows), self.carry[1][self.rows],
                        self.carry[2][self.rows])
            self.kept_logits = []
        self.carry, traj = self.rollout_fn(self.carry, self.chunk)
        if take:
            self.sampled = (carry_in, {**{k: traj[k][:, self.rows] for k in TRAJ_KEYS},
                                       "logits": torch.stack(self.kept_logits)},
                            _rows(self.carry[0], self.rows))
            self.kept_logits = None
        self.calls += 1
        return self.n_envs * self.chunk

    def release(self) -> None:
        self.unplant()
        self.carry = self.rollout_fn = self.model = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def facts(self) -> dict:
        return {"steps_per_call": self.chunk, "n_envs": self.n_envs,
                "flops_per_unit": self.flops_per_env_step, **self.stats}

    def check(self, control: bool = False, witness: bool = False) -> dict:
        """The compared numbers (see the module's docstring). With
        ``control`` the program's place is taken by the reference in lower
        precision from the same start: the simulator and frames of
        ``RefLoop(precision="low")`` driven by the policy in float8 give
        the frame, divergence and state numbers, and the logit gap is read
        for the float8 policy's first choice on the reference's own
        windows, every followed env at every step. With ``witness`` the
        simulator's place is taken by a correct one that rounds otherwise:
        the reference's on the CPU (its reset, and its steps from the
        program's state with the program's actions); the frames and
        logits stay the program's."""
        from perfbench.reference.closed_loop import RefLoop, update_window
        from perfbench.reference.sim import world as rworld

        t, dev = self.t, self.dev
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            ref = RefLoop(t["sim"], t["town"], t["render"], dev)
            low = RefLoop(t["sim"], t["town"], t["render"], dev, precision="low") if control \
                else None
            wit = RefLoop(t["sim"], t["town"], t["render"], "cpu") if witness else None
            return self._compare(ref, low, update_window, rworld, wit)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    def _compare(self, ref, low, update_window, rworld, wit=None) -> dict:
        def as_ref(state):
            return rworld.WorldState(**{f.name: getattr(state, f.name)
                                        for f in dataclasses.fields(rworld.WorldState)})

        n = self.rows.numel()
        alive = torch.ones(n, dtype=torch.bool, device=self.dev)
        off, pixels = 0, 0
        gap, err, sgap = 0.0, 0.0, 0.0
        covering, kept, frames = 0, 0, 0

        def state_check(prog, want):
            nonlocal alive, sgap
            for f in INT_FIELDS:
                a, b = getattr(prog, f), getattr(want, f)
                alive &= (a == b).reshape(n, -1).all(-1)
            for f in FLOAT_FIELDS:
                a, b = getattr(prog, f), getattr(want, f)
                d = ((a - b).abs() / (1.0 + b.abs())).reshape(n, -1).amax(-1)
                alive &= ~torch.isnan(d)
                if alive.any():
                    sgap = max(sgap, float(d[alive].max()))

        def frame_check(prog_u8, want_u8):
            nonlocal off, pixels
            bad = ((prog_u8.to(torch.int16) - want_u8.to(torch.int16)).abs() > 2)[alive]
            off += int(bad.sum())
            pixels += bad.numel()

        # the start: init_fn's states and first frames from the same draws
        st0 = _rows(ref.reset(torch.Generator().manual_seed(self.seed), self.n_envs), self.rows)
        prog0 = self.start[0]
        if low is not None:
            prog0 = _rows(low.reset(torch.Generator().manual_seed(self.seed), self.n_envs),
                          self.rows)
            prog0 = dataclasses.replace(prog0, **{
                f: getattr(prog0, f).to(torch.bfloat16).to(torch.float32) for f in FLOAT_FIELDS})
            start_frame = low.frame(prog0)[0]
        elif wit is not None:
            prog0 = _to(_rows(wit.reset(torch.Generator().manual_seed(self.seed), self.n_envs),
                              self.rows.cpu()), self.dev)
            start_frame = self.start[1][..., 0]
        else:
            start_frame = self.start[1][..., 0]
        state_check(prog0, st0)
        frame_check(start_frame, ref.frame(st0)[0])

        # one timed call, followed from the program's state at its start
        (st_in, win_in, jr_in), traj, st_out = self.sampled
        st = as_ref(st_in)
        win, jr = win_in.clone(), jr_in.clone()
        # the program's own windows, rebuilt from its frames: the policy is
        # judged on the observations it was given, as a served model on its tokens
        pwin, pjr = win_in.clone(), jr_in.clone()
        if low is not None:
            lst, lwin, ljr = st, win.clone(), jr.clone()
            outs = {k: [] for k in TRAJ_KEYS}
            for _ in range(self.chunk):
                g = low.frame(lst)[0]
                lwin = update_window(lwin, g, ljr)
                a = self.reference(self.weights, lwin.float() / 255.0, "fp8").argmax(-1)
                lst, info = low.step(lst, a)
                for k, v in (("gray", g), ("action", a), ("done", info["done"]),
                             ("collision", info["collision"]), ("offroad", info["offroad"]),
                             ("speed", info["speed"])):
                    outs[k].append(v)
                ljr = info["done"]
            traj = {k: torch.stack(v) for k, v in outs.items()}
            st_out = lst
        if wit is not None:
            wst, outs = _to(st, "cpu"), {k: [] for k in ("done", "collision", "offroad", "speed")}
            for step in range(self.chunk):
                wst, info = wit.step(wst, traj["action"][step].to("cpu", torch.int64))
                for k in outs:
                    outs[k].append(info[k].to(self.dev))
            traj = {**traj, **{k: torch.stack(v) for k, v in outs.items()}}
            st_out = _to(wst, self.dev)
        for step in range(self.chunk):
            g, cov, kp = ref.frame(st)
            covering, kept, frames = covering + int(cov.sum()), kept + int(kp.sum()), frames + n
            frame_check(traj["gray"][step], g)
            win = update_window(win, g, jr)
            a = traj["action"][step].to(torch.int64)
            if low is None:
                pwin = update_window(pwin, traj["gray"][step], pjr)
                pjr = traj["done"][step].to(torch.bool)
                logits = self.reference(self.weights, pwin.float() / 255.0)
                span = (logits.amax(-1) - logits.amin(-1)).clamp(min=1e-12)
                d = logits.amax(-1) - logits.gather(1, a[:, None])[:, 0]
                e = (traj["logits"][step] - logits).abs().amax(-1) / span
                gap = max(gap, float(d.max()))
                err = max(err, float(e.max()))
            else:   # the float8 policy on the reference's windows, every env
                obs = win.float() / 255.0
                logits = self.reference(self.weights, obs)
                span = (logits.amax(-1) - logits.amin(-1)).clamp(min=1e-12)
                l8 = self.reference(self.weights, obs, "fp8")
                a8 = l8.argmax(-1)
                gap = max(gap, float((logits.amax(-1) - logits.gather(1, a8[:, None])[:, 0]).max()))
                err = max(err, float(((l8 - logits).abs().amax(-1) / span).max()))
            st, info = ref.step(st, a)
            for k in ("done", "collision", "offroad"):
                alive &= traj[k][step].to(torch.bool) == info[k].to(torch.bool)
            sp = (traj["speed"][step] - info["speed"]).abs() / (1.0 + info["speed"].abs())
            alive &= ~torch.isnan(sp)
            if alive.any():
                sgap = max(sgap, float(sp[alive].max()))
            jr = info["done"]
        state_check(st_out, st)
        self.stats = {"covering_pairs_per_frame": covering / max(frames, 1),
                      "kept_triangles_per_frame": kept / max(frames, 1),
                      "pixels_per_frame": self.t["render"]["height"] * self.t["render"]["width"]}
        return {"frame_off_share": off / max(pixels, 1), "logit_gap_max": gap,
                "logit_err_max": err, "diverged_share": 1.0 - float(alive.float().mean()),
                "state_gap_max": sgap}


def setup(cfg, traffic, seed, dev, fault=None, log=print) -> ClosedLoop:
    return ClosedLoop(cfg, traffic, seed, dev, fault=fault)
