"""Checkpoint/resume for sharded training state.

The port of yoda_scheduler_tpu/parallel/checkpoint.py. Elastic recovery for
the long-running training jobs the scheduler places: persist (step, params,
opt_state), restore onto a possibly different mesh, continue bit-exact.

Design notes:
- each rank writes its own shards (``<directory>/<step>/rank_<r>.pt``), no
  gather to rank 0, so checkpoint bandwidth scales with the ranks. Every
  piece carries its leaf name and its offsets in the whole tensor; of the
  ranks that hold the same piece (a leaf replicated over an axis its spec
  does not name), only the one at index 0 of those axes writes it, so
  every piece is written exactly once
- the restore layout is the template's: this rank's shards under the
  checkpointer's mesh and specs. Each target shard is assembled from the
  saved pieces that overlap it, so restoring onto a different mesh shape
  (or over pp) is restoring with another mesh; a target element that no
  saved piece covers raises
- the saved values are copied into the template's own tensors, the ones
  its AdamW holds, and the optimizer's state (step count, both moments in
  the leaf's dtype) is loaded into the template's optimizer
- a save is synchronous and commits by renaming the step's directory once
  every rank has written; the newest `max_to_keep` steps are kept
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from types import SimpleNamespace

import torch
import torch.distributed as dist

from .mesh import AXIS_ORDER, one_device_mesh
from .sharding import _axes, llama_param_specs


def _pieces(params: dict, mesh, specs: dict):
    """(name, tensor, offsets, global shape, writes) of every leaf this rank
    holds; layer names carry the global layer index."""
    list_axes = _axes(specs["layer_list"])
    first = 0
    if list_axes and mesh.size(list_axes) > 1:
        first = mesh.index(list_axes) * len(params["layers"])
    named = [(n, params[n], specs[n], ()) for n in ("embed", "final_norm", "lm_head")]
    named += [(f"layers.{first + i}.{n}", t, specs["layers"][n], list_axes)
              for i, layer in enumerate(params["layers"]) for n, t in layer.items()]
    for name, t, spec, extra in named:
        offsets, shape, held = [], [], set(extra)
        for dim, entry in enumerate(spec):
            axes = _axes(entry)
            held.update(axes)
            axis = mesh.axis(axes) if axes else None
            n = axis.size if axis else 1
            offsets.append(axis.index * t.shape[dim] if axis else 0)
            shape.append(t.shape[dim] * n)
        writes = all(mesh.index(a) == 0 for a in AXIS_ORDER if a not in held)
        yield name, t, offsets, shape, writes


def _owned(t: torch.Tensor) -> torch.Tensor:
    """`t` without autograd on the host, cloned where it views a larger
    storage (which torch.save would write whole)."""
    t = t.detach().cpu()
    return t.clone() if t.untyped_storage().nbytes() > t.nbytes else t


def _overlap(dst_off, dst_shape, src_off, src_shape):
    """(dst slices, src slices) of the overlap of two boxes, None if empty."""
    dst, src = [], []
    for do, dn, so, sn in zip(dst_off, dst_shape, src_off, src_shape):
        lo, hi = max(do, so), min(do + dn, so + sn)
        if lo >= hi:
            return None
        dst.append(slice(lo - do, hi - do))
        src.append(slice(lo - so, hi - so))
    return tuple(dst), tuple(src)


class TrainCheckpointer:
    """Save/restore (step, params, opt_state) of the train steps in
    parallel/train.py and parallel/pipeline.py.

    Usage:
        ckpt = TrainCheckpointer(dir, max_to_keep=3)
        ckpt.save(step, params, opt_state)
        step, params, opt_state = ckpt.restore((params0, opt0))  # latest

    `mesh` and `specs` say how this rank's tensors lie in the whole ones,
    as `shard_params` takes them: mesh None is one device (`device`, whole
    tensors), specs None `llama_param_specs` (the pipelined step's state
    needs `llama_pipeline_param_specs`). Every rank of the mesh calls
    save and restore; the directory is shared by every rank."""

    def __init__(self, directory: str, max_to_keep: int = 3, mesh=None, specs=None,
                 device="cuda"):
        self.directory = Path(directory).resolve()
        self.max_to_keep = max_to_keep
        self.mesh = mesh if mesh is not None else one_device_mesh(device)
        self.specs = specs
        self.directory.mkdir(parents=True, exist_ok=True)

    def _specs(self, params: dict) -> dict:
        if self.specs is not None:
            return self.specs
        # the expert leaves tell a MoE state from a dense one
        return llama_param_specs(SimpleNamespace(is_moe="we_gate" in params["layers"][0]))

    def _barrier(self) -> None:
        if self.mesh.grid.size > 1:
            dist.barrier()

    def save(self, step: int, params: dict, opt_state) -> None:
        """Persist the state and return once every rank's file is written
        and the step committed. Synchronous on purpose: the train steps
        update (params, opt_state) in place, so the next step_fn call would
        change what an asynchronous save still reads."""
        latest = self.latest_step()
        if latest is not None and step <= latest:
            # a silently skipped save after restoring an older step would
            # resume from divergent weights on the next crash
            raise ValueError(
                f"checkpoint step {step} was not saved (latest existing step"
                f" is {latest}; steps must increase). After restoring an older"
                " step, delete the newer checkpoints or save under a fresh step"
                " number.")
        rank = self.mesh.rank
        partial = self.directory / f"{step}.partial"
        if rank == 0:
            shutil.rmtree(partial, ignore_errors=True)  # a crashed save's
            partial.mkdir()
        self._barrier()
        tensors, boxes, opt_step = {}, {}, None
        for name, t, offsets, shape, writes in _pieces(params, self.mesh,
                                                       self._specs(params)):
            state = opt_state.state.get(t, {})
            if "step" in state:
                opt_step = float(state["step"])
            if not writes:
                continue
            tensors[name], boxes[name] = _owned(t), (offsets, shape)
            for key, v in state.items():
                if key != "step":
                    tensors[f"{key}/{name}"], boxes[f"{key}/{name}"] = _owned(v), (
                        offsets, shape)
        path = partial / f"rank_{rank}.pt"
        with open(path.with_suffix(".tmp"), "wb") as f:
            torch.save({"tensors": tensors, "boxes": boxes}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(path.with_suffix(".tmp"), path)
        self._barrier()
        if rank == 0:
            (partial / "meta.json").write_text(json.dumps(
                {"step": step, "optimizer_step": opt_step}))
            os.replace(partial, self.directory / str(step))
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self.directory / str(old))
        self._barrier()

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / "meta.json").is_file())

    def restore(self, template, step: int | None = None):
        """Restore (step, params, opt_state) into `template` = (params,
        opt_state), typically the train step's init_fn output on this
        checkpointer's mesh: the saved values are copied into the
        template's tensors in place and the optimizer's state is loaded
        into its optimizer; both are returned."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint steps under {self.directory}")
        params, opt_state = template
        where = self.directory / str(step)
        meta = json.loads((where / "meta.json").read_text())
        saved = [torch.load(p, map_location="cpu", mmap=True, weights_only=True)
                 for p in sorted(where.glob("rank_*.pt"))]
        index = {}  # key -> [(tensor, offsets, shape)] over every rank's file
        for f in saved:
            for key, (offsets, shape) in f["boxes"].items():
                index.setdefault(key, []).append((f["tensors"][key], offsets, shape))

        def fill(dst, key, offsets, shape):
            covered = 0
            for src, s_off, s_shape in index.get(key, []):
                if list(s_shape) != shape:
                    raise ValueError(f"checkpoint step {step}: {key} is {s_shape} "
                                     f"whole, the template's is {shape}")
                hit = _overlap(offsets, dst.shape, s_off, src.shape)
                if hit is not None:
                    dst[hit[0]].copy_(src[hit[1]])
                    covered += dst[hit[0]].numel()
            if covered != dst.numel():
                raise ValueError(f"checkpoint step {step} covers {covered} of the "
                                 f"{dst.numel()} elements of this rank's {key}")

        state_keys = sorted({k.split("/", 1)[0] for k in index if "/" in k})
        moments = {}
        with torch.no_grad():
            for name, t, offsets, shape, _ in _pieces(params, self.mesh,
                                                      self._specs(params)):
                if t.device.type != self.mesh.device.type:
                    raise ValueError(f"{name} is on {t.device}, the checkpointer's "
                                     f"mesh on {self.mesh.device}")
                fill(t, name, offsets, shape)
                if meta["optimizer_step"] is None:
                    continue
                moments[t] = {"step": torch.tensor(meta["optimizer_step"],
                                                   dtype=torch.float32)}
                for key in state_keys:
                    v = torch.empty_like(t)
                    fill(v, f"{key}/{name}", offsets, shape)
                    moments[t][key] = v
        order = [p for g in opt_state.param_groups for p in g["params"]]
        if meta["optimizer_step"] is not None and set(map(id, order)) != set(
                map(id, moments)):
            raise ValueError("the template's optimizer does not hold exactly the "
                             "template's parameters")
        opt_state.load_state_dict({
            "state": {i: moments[p] for i, p in enumerate(order) if p in moments},
            "param_groups": opt_state.state_dict()["param_groups"]})
        return step, params, opt_state

    def close(self) -> None:
        """Nothing to release: every save has finished when it returns."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
