"""Traffic kind ``bc_epoch``: behaviour cloning through the port's fused
epoch (``training.steps.make_fused_epoch(bc_loss_fn,
DeviceDataset.pure_batch)``, the path ``Trainer.fit`` takes for a dataset
on the card), every timed call one epoch call of ``batches_per_call``
batches.

Traffic keys: ``n_frames`` uint8 frames of ``height`` × ``width`` (random
from the seed, with random actions), ``batch``, ``frame_skip``,
``batches_per_call``, ``learning_rate``, ``clip``, ``warm_calls``,
``trace_calls``.

Set-up builds the one train state the window uses and drives it from the
seed through its first three steps with the window's own call: a call of
one batch, then a call of two, on order rows that all differ. The check
follows those three steps with the plain reference (``reference/train.py``
on the configuration's float32 model) from the same weights and frames.
It also follows one timed call drawn from the seed (one of the first
three), from the program's state at its start as the port's checkpoint
payload gives it (weights, Adam's moments and step count), through all
of its batches. Compared numbers:

- ``loss_gap``: the largest |program − reference| / reference over the
  three steps' losses;
- ``grad_gap``: over the parameter leaves, the largest gap between the
  norms of the program's first clipped gradient (worked out from Adam's
  first moment after one step) and the reference's, over the larger of
  the reference leaf's norm and the median leaf's;
- ``update_gap``: the same of the parameters' change over the three
  steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (the others, such as the attention
  key's bias, have no gradient but round-off and move by it alone);
- ``call_loss_gap``: the largest relative gap of the timed call's
  losses, step by step;
- ``call_update_gap``: the median over the leaves (chosen by the
  reference's gradient at the call's first step) of the gap of their
  change over the timed call, measured as ``update_gap``'s. Not the
  worst leaf: once Adam's second moment has settled, a leaf whose
  gradient sits near bfloat16's rounding (the queries' early in
  training) moves by a share of its rounding, up to twice the
  reference's change over one call.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.kinds import policy as policy_lib

FAULTS = ("half_batch", "answer_altered")


def _owned(tree):
    """A copy of a nest of dicts and lists that owns its tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _owned(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_owned(v) for v in tree)
    return tree


class BCEpoch:
    rate_metric = "train_images_per_s"

    def __init__(self, cfg, traffic, seed, dev, fault=None, log=print):
        from carla_imitation_learning_tpu_torch.data.pipeline import DeviceDataset, FrameStore
        from carla_imitation_learning_tpu_torch.training import bc_loss_fn
        from carla_imitation_learning_tpu_torch.training.steps import (
            create_train_state, make_fused_epoch, make_optimizer,
        )

        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.t, self.dev, self.seed, self.log = traffic, dev, seed, log
        self.batch, self.per_call = traffic["batch"], traffic["batches_per_call"]
        n, h, w = traffic["n_frames"], traffic["height"], traffic["width"]
        rng = np.random.default_rng(seed)
        self.frames = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
        self.actions = rng.integers(0, 9, n).astype(np.int32)
        self.sample_call = int(rng.integers(0, min(3, traffic["trace_calls"])))
        self.min_calls = self.sample_call + 1
        store = FrameStore(frames=self.frames, actions=self.actions,
                           traffic=np.zeros(n, np.int32), sensors=np.zeros((n, 3), np.float32))
        ds = DeviceDataset(store, batch_size=self.batch, frame_skip=traffic["frame_skip"],
                           shuffle=True, dtype=cfg["compute_dtype"], device=dev)
        self.n_samples = ds.n_samples
        model, self.weights, self.reference = policy_lib.build(cfg, seed, dev)
        self.x_shape = (self.batch, h, w, traffic["frame_skip"])
        self.flops_per_image = policy_lib.flops(model, self.x_shape, backward=True) / self.batch
        tx = make_optimizer({"LEARNING_RATE": traffic["learning_rate"],
                             "gradient_clip_val": traffic["clip"]}, 1)
        self.state = create_train_state(model, tx, device=dev)
        pure_batch = ds.pure_batch
        loss_fn = bc_loss_fn
        if fault == "half_batch":
            def pure_batch(idx):
                x, y = ds.pure_batch(idx)
                return x[: x.shape[0] // 2], y[: y.shape[0] // 2]
        elif fault == "answer_altered":
            def loss_fn(model, batch, generator=None):
                loss, metrics = bc_loss_fn(model, batch, generator)
                return loss * 1.1, {**metrics, "loss": metrics["loss"] * 1.1}
        self.epoch = make_fused_epoch(loss_fn, pure_batch)
        self.order_gen = torch.Generator(device=dev)
        self.order_gen.manual_seed(int(seed) % (2 ** 63))

        # the first three steps, followed by the check
        self.first_orders = [self._orders(1), self._orders(2)]
        _, _, m1 = self.epoch(self.state, self.first_orders[0])
        b1 = self.state.optimizer.param_groups[0]["betas"][0]
        names = dict(self.state.model.named_parameters())
        self.param_names = list(names)
        self.first_grad = {k: self.state.optimizer.state[p]["exp_avg"].detach() / (1 - b1)
                           for k, p in names.items()}
        _, _, m23 = self.epoch(self.state, self.first_orders[1])
        self.after_three = {k: p.detach().clone() for k, p in names.items()}
        self.losses = torch.cat([m1["loss"], m23["loss"]])
        for _ in range(traffic["warm_calls"]):
            self.epoch(self.state, self._orders(self.per_call))
        self.calls, self.sampled = 0, None

    def _orders(self, n_batches: int) -> torch.Tensor:
        return torch.randint(0, self.n_samples, (n_batches, self.batch), device=self.dev,
                             generator=self.order_gen)

    def call(self) -> int:
        take = self.calls == self.sample_call
        start = _owned(self.state.payload()) if take else None
        order = self._orders(self.per_call)
        _, _, metrics = self.epoch(self.state, order)
        if take:
            self.sampled = (start, order, metrics["loss"],
                            {k: p.detach().clone()
                             for k, p in self.state.model.named_parameters()})
        self.calls += 1
        return self.per_call * self.batch

    def release(self) -> None:
        self.state = self.epoch = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def facts(self) -> dict:
        return {"flops_per_unit": self.flops_per_image, "images_per_call":
                self.per_call * self.batch, "steps_per_call": self.per_call}

    def check(self, control: bool = False) -> dict:
        """The compared numbers (see the module's docstring). With
        ``control`` the program's place is taken by the reference computed
        in float8, and its numbers are returned instead."""
        from perfbench.reference.train import bc_steps, windows

        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            frames = torch.from_numpy(self.frames)
            actions = torch.from_numpy(self.actions)

            def batches(orders):
                out = []
                for order in orders:
                    for row in order.cpu():
                        x, y = windows(frames, actions, row, self.t["frame_skip"])
                        out.append((x.to(self.dev), y.to(self.dev)))
                return out

            def low(w, x):
                return self.reference(w, x, "fp8")

            kw = {"lr": self.t["learning_rate"], "clip": self.t["clip"]}
            first = batches(self.first_orders)
            losses, g_ref, p_ref = bc_steps(self.reference, self.weights, first, **kw)
            if control:
                got_losses, g_got, p_got = bc_steps(low, self.weights, first, **kw)
            else:
                got_losses = self.losses.float().cpu().tolist()
                g_got, p_got = self.first_grad, self.after_three

            # the timed call, from the program's state at its start
            start, order, call_losses, call_after = self.sampled
            w0 = start["params"]
            moments = ({k: torch.zeros_like(v) for k, v in w0.items()},
                       {k: torch.zeros_like(v) for k, v in w0.items()}, start["step"])
            for i, st in start["opt_state"]["state"].items():
                moments[0][self.param_names[i]] = st["exp_avg"]
                moments[1][self.param_names[i]] = st["exp_avg_sq"]
            call_batches = batches([order])
            c_ref, cg_ref, cp_ref = bc_steps(self.reference, w0, call_batches, moments=moments,
                                             **kw)
            if control:
                c_got, _, cp_got = bc_steps(low, w0, call_batches, moments=moments, **kw)
            else:
                c_got, cp_got = call_losses.float().cpu().tolist(), call_after
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

        def loss_gaps(got, want):
            return [abs(a - b) / abs(b) for a, b in zip(got, want, strict=True)]

        loss_gap, call_loss_gap = loss_gaps(got_losses, losses), loss_gaps(c_got, c_ref)
        self.log(f"loss gap by step: {loss_gap}; in the timed call: {call_loss_gap}")

        def norms(d):
            return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}

        def gaps(got: dict, want: dict, keys, what: str) -> dict:
            floor = float(np.median([want[k] for k in keys]))
            gap = {k: abs(got[k] - want[k]) / max(want[k], floor) for k in keys}
            k = max(gap, key=gap.get)
            self.log(f"{what}: worst leaf {k} {gap[k]:.6g} (program {got[k]:.6g}, reference "
                     f"{want[k]:.6g}, median {floor:.6g}), median gap "
                     f"{float(np.median(list(gap.values()))):.6g} of {len(keys)}")
            return gap

        def moving(grads):
            g = norms(grads)
            median_g = float(np.median(list(g.values())))
            return [k for k in g if g[k] >= 1e-3 * median_g]

        def update_gaps(got, want, w0, keys, what):
            return gaps(norms({k: got[k] - w0[k] for k in keys}),
                        norms({k: want[k] - w0[k] for k in keys}), keys, what)

        gr = norms(g_ref)
        call = update_gaps(cp_got, cp_ref, w0, moving(cg_ref), "call")
        return {"loss_gap": max(loss_gap),
                "grad_gap": max(gaps(norms(g_got), gr, list(gr), "gradient").values()),
                "update_gap": max(update_gaps(p_got, p_ref, self.weights, moving(g_ref),
                                              "update").values()),
                "call_loss_gap": max(call_loss_gap),
                "call_update_gap": float(np.median(list(call.values())))}


def setup(cfg, traffic, seed, dev, fault=None, log=print) -> BCEpoch:
    return BCEpoch(cfg, traffic, seed, dev, fault=fault, log=log)
