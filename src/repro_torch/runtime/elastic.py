"""Elastic, fault-tolerant training executor on one card (twin of
``repro.runtime.elastic.ElasticTrainer``). It trains every model family
of the registry: attention, RWKV-6 and Mamba/attention stacks, MoE layers,
and the audio and vlm batch layouts (``launch.steps.make_train_step``).

A revocation notice (``preempt_at``) runs the reference's discipline:
    finish the current step -> blocking checkpoint -> release the state ->
    rebuild the step on the device given -> restore -> continue from the
    same data-stream position (batch ``i`` is a pure function of the seed).
On one card that is the single-card form of a revocation: the run moves to
a replacement card, here the same device id. Every notice is a revocation
and runs, however close to the one before. Meshes, ``model_par != 1`` and
more than one device are mesh tooling, not ported (ROADMAP Queue A, item
11) and raise; the reference's rescale hysteresis (``spec``), which defers
grows of the device count, comes with them.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.data.pipeline import SyntheticBatches
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.decoder import DecoderLM
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.straggler import StragglerWatchdog
from repro_torch.tree import map_tree

_MESH = ("the port trains on one device; meshes, model parallelism and "
         "multi-device training are ROADMAP Queue A item 11 (A11)")


def _one_device(devices) -> torch.device:
    if len(devices) != 1:
        raise NotImplementedError(f"{len(devices)} devices: {_MESH}")
    return resolve_device(devices[0])


class ElasticTrainer:
    def __init__(self, model: DecoderLM, opt: AdamW, data: SyntheticBatches,
                 ckpt: Checkpointer, *, model_par: int = 1, devices=None,
                 log: Optional[Callable[[str], None]] = None):
        if model_par != 1:
            raise NotImplementedError(f"model_par={model_par}: {_MESH}")
        self.model = model
        self.opt = opt
        self.data = data
        self.ckpt = ckpt
        self.devices = list(devices) if devices is not None else [resolve_device(None)]
        self.log = log or (lambda s: None)
        self.watchdog = StragglerWatchdog()
        self.history = []  # (step, loss, n_devices)
        self.rescales = 0
        self._build(self.devices)

    # ---------------------------------------------------------------- builds

    def _build(self, devices):
        self.device = _one_device(devices)
        self.step_fn = make_train_step(self.model, self.opt)

    def _init_state(self, seed: int):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return self.opt.init_state(self.model.init(gen, device=self.device))

    def _abstract_state(self):
        """The train state's tree on the ``meta`` device, built by the SAME
        constructor the live path uses (``opt.init_state``), so a restore
        from cold cannot drift from the live layout."""
        return self.opt.init_state(self.model.init(torch.Generator(), device="meta"))

    # ------------------------------------------------------------------- run

    def rescale(self, devices, step: int, state):
        """Drain -> checkpoint -> release -> rebuild -> restore -> resume.
        ``state`` is emptied once it is on disk, so the card never holds
        two copies of it."""
        self.log(f"rescale at step {step}: {len(self.devices)} -> "
                 f"{len(devices)} devices")
        _one_device(devices)
        self.ckpt.save(step, state, blocking=True)
        template = map_tree(
            lambda _, x: x if isinstance(x, int) else x.to("meta"), state)
        state.clear()
        self.devices = list(devices)
        self._build(self.devices)
        state, _ = self.ckpt.restore(template, step=step, device=self.device)
        self.rescales += 1
        return state

    def run(self, total_steps: int, *, seed: int = 0,
            preempt_at: Optional[Dict[int, int]] = None,
            checkpoint_every: int = 50):
        """``preempt_at``: {step: device count} revocation notices; the
        count must be 1 here."""
        preempt_at = preempt_at or {}
        start = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            state, start = self.ckpt.restore(self._abstract_state(),
                                             device=self.device)
            start += 1
            self.log(f"restored checkpoint at step {start - 1}")
        else:
            state = self._init_state(seed)

        for step in range(start, total_steps):
            n_dev = preempt_at.get(step)
            if n_dev is not None:
                state = self.rescale(self.devices[:1] * n_dev, step, state)
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, self.data.batch(step))
            loss = float(metrics["loss"])  # waits for the step
            self.watchdog.observe(0, time.perf_counter() - t0)
            self.history.append((step, loss, len(self.devices)))
            if checkpoint_every and step and step % checkpoint_every == 0:
                self.ckpt.save(step, state)
        self.ckpt.save(total_steps - 1, state, blocking=True)
        return state
