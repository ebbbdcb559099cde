"""Elastic, fault-tolerant training executor (twin of
``repro.runtime.elastic.ElasticTrainer``). It trains every model family
of the registry: attention, RWKV-6 and Mamba/attention stacks, MoE layers,
and the audio and vlm batch layouts (``launch.steps.make_train_step``).

Maps CloudCoaster's drain->shutdown discipline onto SPMD training: a
revocation notice (``preempt_at``) triggers
    finish the current step -> blocking checkpoint -> rebuild the mesh on
    the surviving ranks -> restore resharded -> continue from the same
    data-stream position (batch ``i`` is a pure function of the seed).
The global batch is kept across rescales: the per-rank batch grows.

Two forms, chosen by whether ``torch.distributed`` is initialised:

  * a mesh: ``devices`` are ranks of the default process group (default:
    all of them), laid out as a (data, model) ``DeviceMesh`` with
    ``model_par`` ranks along "model" (``_mesh_from``). The state and each
    batch are DTensors laid out by the config's layout rules
    (``parallel.layouts``), and every step runs under the sharding
    context. Building a mesh is collective over the default group, so
    every rank constructs the trainer and takes part in each rescale; a
    rank the rescale leaves out leaves the step loop and waits at the end
    of ``run``;
  * one device (no process group): ``devices`` holds one device; a
    revocation moves the run to a replacement card, here the same device.

The trainer shares the scheduling layer with the simulators: pass a
``repro_torch.sched.ControllerSpec`` and its ``provisioning_delay`` becomes
the rescale-hysteresis window (in steps) — two fleet changes within one
provisioning window are the add/drain oscillation the controller's
projection avoids, so the trainer coalesces them into one.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.data.pipeline import SyntheticBatches
from repro_torch.device import resolve_device
from repro_torch.launch.specs import batch_partition, batch_struct, fix_divisibility
from repro_torch.launch.steps import make_train_step, train_state_specs
from repro_torch.models.decoder import DecoderLM
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel import use_sharding_ctx
from repro_torch.parallel.distribute import distribute_tree
from repro_torch.parallel.layouts import layout_rules, param_specs, to_shardings
from repro_torch.runtime.straggler import StragglerWatchdog
from repro_torch.tree import map_tree


def _distributed() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _mesh_from(devices, model_par: int):
    """A (data, model) ``DeviceMesh`` over the ranks ``devices``; the mesh's
    device type follows the default group's backend (NCCL: cuda)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = len(devices)
    assert n % model_par == 0
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.tensor([int(d) for d in devices]).reshape(n // model_par, model_par)
    return DeviceMesh(kind, ranks, mesh_dim_names=("data", "model"))


class ElasticTrainer:
    def __init__(self, model: DecoderLM, opt: AdamW, data: SyntheticBatches,
                 ckpt: Checkpointer, *, model_par: int = 1, devices=None,
                 log: Optional[Callable[[str], None]] = None, spec=None):
        self.model = model
        self.opt = opt
        self.data = data
        self.ckpt = ckpt
        self.model_par = model_par
        self.mesh_mode = _distributed()
        if self.mesh_mode:
            import torch.distributed as dist

            self.devices = list(devices if devices is not None
                                else range(dist.get_world_size()))
        else:
            if model_par != 1:
                raise ValueError(f"model_par={model_par} needs a mesh: initialise "
                                 f"torch.distributed first")
            self.devices = list(devices) if devices is not None else [resolve_device(None)]
        self.log = log or (lambda s: None)
        self.watchdog = StragglerWatchdog()
        self.history = []  # (step, loss, n_devices)
        self.rescales = 0
        self.spec = spec  # hysteresis window = spec.provisioning_delay steps
        self._last_rescale_step: Optional[int] = None
        self._deferred_n_dev: Optional[int] = None
        self.n_coalesced_rescales = 0
        self._build(self.devices)

    # ---------------------------------------------------------------- builds

    def _build(self, devices):
        if not self.mesh_mode:
            if len(devices) != 1:
                raise ValueError(f"{len(devices)} devices need a mesh: initialise "
                                 f"torch.distributed first")
            self.device = resolve_device(devices[0])
            self.mesh = self.rules = None
            self.step_fn = make_train_step(self.model, self.opt)
            return
        self.step_fn = make_train_step(self.model, self.opt)
        import torch.distributed as dist

        self.mesh = _mesh_from(devices, self.model_par)
        self.member = dist.get_rank() in [int(d) for d in devices]
        self.device = torch.device(self.mesh.device_type)
        cfg = self.model.cfg
        self.rules = layout_rules(self.mesh, cfg, "train",
                                  global_batch=self.data.global_batch)
        pspec = param_specs(self.model.init_shape(), self.mesh, self.rules)
        self.state_shardings = to_shardings(train_state_specs(pspec, self.opt), self.mesh)
        bstruct = batch_struct(cfg, "train", self.data.global_batch, self.data.seq_len)
        self.batch_shardings = to_shardings(fix_divisibility(
            batch_partition(cfg, "train", self.rules), bstruct, self.mesh), self.mesh)

    def _init_state(self, seed: int):
        """The port's seeded init on every rank (the same weights on each),
        laid out on the mesh where there is one."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self.model.init(gen, device=self.device)
        if self.mesh is not None:
            params = distribute_tree(params, self.state_shardings["params"])
        return self.opt.init_state(params)

    def _abstract_state(self):
        """The train state's tree on the ``meta`` device, built by the SAME
        constructor the live path uses (``opt.init_state``), so a restore
        from cold cannot drift from the live layout."""
        return self.opt.init_state(self.model.init_shape())

    def _restore(self, template, step=None):
        if self.mesh is None:
            return self.ckpt.restore(template, step=step, device=self.device)
        return self.ckpt.restore(template, step=step, shardings=self.state_shardings)

    # ------------------------------------------------------------------- run

    def _within_hysteresis(self, step: int, n_dev: int) -> bool:
        """Discretionary grows inside one provisioning window are deferred
        (the §3.2 anti-thrash projection); shrinks are revocations and must
        always run."""
        return (self.spec is not None
                and n_dev >= len(self.devices)
                and self._last_rescale_step is not None
                and step - self._last_rescale_step
                < self.spec.provisioning_delay)

    def _plan_rescale(self, step: int, requested: Optional[int]
                      ) -> Optional[int]:
        """Device count to rescale to at this step, or None to hold.

        Grows landing inside the hysteresis window are deferred to the end
        of the window (a newer request — including a shrink, which always
        applies — supersedes a deferred one); they are never dropped."""
        n_dev = requested
        if n_dev is None and self._deferred_n_dev is not None \
                and not self._within_hysteresis(step, self._deferred_n_dev):
            if self._deferred_n_dev != len(self.devices):  # not moot
                n_dev = self._deferred_n_dev
            self._deferred_n_dev = None
        if n_dev is not None and self._within_hysteresis(step, n_dev):
            self._deferred_n_dev = n_dev
            self.n_coalesced_rescales += 1
            self.log(f"rescale to {n_dev} at step {step} deferred "
                     f"(within the provisioning window)")
            return None
        return n_dev

    def rescale(self, devices, step: int, state):
        """Drain -> checkpoint -> rebuild -> restore -> resume. On a mesh
        the new mesh is built over ``devices`` (every rank takes part) and
        the state is restored resharded onto it; off a mesh the state is
        emptied once it is on disk, so the card never holds two copies."""
        self.log(f"rescale at step {step}: {len(self.devices)} -> "
                 f"{len(devices)} devices")
        self.ckpt.save(step, state, blocking=True)
        template = map_tree(
            lambda _, x: x if isinstance(x, int) else torch.empty(
                x.shape, dtype=x.dtype, device="meta"), state)
        state.clear()
        self.devices = list(devices)
        self._build(self.devices)
        self.rescales += 1
        if self.mesh is not None and not self.member:
            return None
        state, _ = self._restore(template, step=step)
        return state

    def _devices_for(self, n_dev: int):
        if self.mesh is None:
            return self.devices[:1] * n_dev
        import torch.distributed as dist

        return list(range(dist.get_world_size()))[:n_dev]

    def run(self, total_steps: int, *, seed: int = 0,
            preempt_at: Optional[Dict[int, int]] = None,
            checkpoint_every: int = 50):
        """``preempt_at``: {step: device count} revocation notices (off a
        mesh the count must be 1). Returns the final state (None on a rank
        outside the final mesh)."""
        preempt_at = preempt_at or {}
        if self.mesh is not None and not self.member:
            return self._finish(None, total_steps)
        start = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            state, start = self._restore(self._abstract_state())
            start += 1
            self.log(f"restored checkpoint at step {start - 1}")
        else:
            state = self._init_state(seed)

        for step in range(start, total_steps):
            n_dev = self._plan_rescale(step, preempt_at.get(step))
            if n_dev is not None:
                self._deferred_n_dev = None
                if self.mesh is None and n_dev != 1:
                    raise ValueError(f"a revocation to {n_dev} devices needs a mesh: "
                                     f"initialise torch.distributed first")
                state = self.rescale(self._devices_for(n_dev), step, state)
                self._last_rescale_step = step
                if state is None:  # this rank left the mesh
                    return self._finish(None, total_steps)
            batch = self.data.batch(step)
            t0 = time.perf_counter()
            if self.mesh is None:
                state, metrics = self.step_fn(state, batch)
            else:
                batch = distribute_tree({k: torch.as_tensor(v) for k, v in batch.items()},
                                        self.batch_shardings)
                with use_sharding_ctx(self.mesh, self.rules):
                    state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])  # waits for the step
            self.watchdog.observe(0, time.perf_counter() - t0)
            self.history.append((step, loss, len(self.devices)))
            if checkpoint_every and step and step % checkpoint_every == 0:
                self.ckpt.save(step, state)
        self.ckpt.save(total_steps - 1, state, blocking=True)
        return self._finish(state, total_steps)

    def _finish(self, state, total_steps):
        """On a mesh every rank of the default group leaves ``run`` together,
        those the last rescale left out included."""
        if self.mesh is not None:
            import torch.distributed as dist

            dist.barrier()
        return state
