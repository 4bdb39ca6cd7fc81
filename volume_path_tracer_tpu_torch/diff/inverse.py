"""Inverse rendering: recover density / temperature grids from target images.

Port of volume_path_tracer_tpu/diff/inverse.py on one device. The loss
renders a pixel batch `samples_per_step` times through the path-replay
renderer (diff/prb.py trace_rays_prb: on the card the record kernel forward
and the replay kernel backward), its ray batch made by render/megakernel.py
loss_rays (on the card one launch that waits for nothing), and compares
the per-pixel mean with the target; the train step divides the gradient by
the loss's count and hands it to torch.optim.Adam, the update optax.adam
makes (its rounding order differs). Checkpoints keep the JAX package's file
layout, so a checkpoint crosses packages in both directions. With a mesh
(parallel/shard.py) each cell takes a rays shard and an 'spp' wave, and the
gradients and the loss are summed over every cell before the update.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..grids.grid import pack_corner_rows
from ..grids.majorant import build_majorants
from ..models.camera import Camera
from ..models.medium import Medium, pack_fused_rows
from ..parallel.shard import Mesh, to_device, tree_sum
from ..render.integrator import IntegratorParams, trace_rays_diff
from ..render.megakernel import loss_rays
from ..utils.spans import span
from .prb import trace_rays_prb


class OptimizableGrids(NamedTuple):
    """The optimized leaves. Density = softplus(log_density) keeps it >= 0."""

    log_density: torch.Tensor  # [X, Y, Z]
    temperature: Optional[torch.Tensor] = None  # the raw adimensional grid, or None


def grid_leaves(grids: OptimizableGrids):
    """The grids' tensors in the JAX package's leaf order (None left out)."""
    return [x for x in grids if x is not None]


def make_optimizer(grids: OptimizableGrids, lr: float = 1e-2) -> torch.optim.Adam:
    """torch.optim.Adam over the grids' tensors, with optax.adam's defaults
    (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(grid_leaves(grids), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def save_train_checkpoint(path, grids: OptimizableGrids, opt_state: torch.optim.Adam, step: int) -> None:
    """Write (grids, optimizer state, step) at a step boundary, in the JAX
    package's layout: `step`, `n_leaves` and `leaf_i` in optax's leaf order
    (the grids, then Adam's count, first moments, second moments). A fresh
    optimizer writes count 0 and zero moments, as optax.adam's init."""
    leaves = grid_leaves(grids)
    states = [opt_state.state.get(p, {}) for p in leaves]
    count = int(states[0]["step"]) if states and "step" in states[0] else 0
    mu = [s["exp_avg"] if "exp_avg" in s else torch.zeros_like(p) for s, p in zip(states, leaves)]
    nu = [s["exp_avg_sq"] if "exp_avg_sq" in s else torch.zeros_like(p) for s, p in zip(states, leaves)]
    arrays = [p.detach().cpu().numpy() for p in leaves] + [np.asarray(count, dtype=np.int32)]
    arrays += [m.detach().cpu().numpy() for m in mu] + [v.detach().cpu().numpy() for v in nu]
    payload = {f"leaf_{i}": a for i, a in enumerate(arrays)}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, step=step, n_leaves=len(arrays), **payload)
    os.replace(tmp, path)


def load_train_checkpoint(path, grids_like: OptimizableGrids, opt_state_like: torch.optim.Adam):
    """Returns (grids, optimizer, step), or None when the file is absent or
    its leaves do not fit the templates. The grids' tensors are written in
    place and the optimizer's state set, so `opt_state_like` keeps working
    on the same tensors."""
    if not os.path.exists(path):
        return None
    z = np.load(path)
    leaves = grid_leaves(grids_like)
    m = len(leaves)
    if int(z["n_leaves"]) != 3 * m + 1:
        return None
    arrays = [z[f"leaf_{i}"] for i in range(3 * m + 1)]
    shapes = [tuple(p.shape) for p in leaves]
    if [a.shape for a in arrays[:m]] != shapes or arrays[m].shape != () or \
            [a.shape for a in arrays[m + 1:]] != shapes * 2:
        return None
    count = int(arrays[m])
    with torch.no_grad():
        for p, a in zip(leaves, arrays[:m]):
            p.copy_(torch.from_numpy(np.asarray(a, dtype=np.float32)))
    for i, p in enumerate(leaves):
        opt_state_like.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.from_numpy(np.asarray(arrays[m + 1 + i], dtype=np.float32)).to(p.device),
            "exp_avg_sq": torch.from_numpy(np.asarray(arrays[2 * m + 1 + i], dtype=np.float32)).to(p.device),
        }
    return grids_like, opt_state_like, int(z["step"])


def density_from_param(p: torch.Tensor) -> torch.Tensor:
    """softplus(p) as jax.nn.softplus computes it, log(1 + e^p) at every p
    (torch's F.softplus returns p itself above its threshold of 20)."""
    return torch.logaddexp(p, torch.zeros((), dtype=p.dtype, device=p.device))


def param_from_density(d: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """The inverse of density_from_param, with the density floored at eps."""
    d = torch.clamp(d, min=eps)
    return d + torch.log(-torch.expm1(-d))


def medium_with_params(base: Medium, grids: OptimizableGrids, bloat: float = 0.1, pack: bool = False) -> Medium:
    """The medium of the optimized leaves, rebuilt every step.

    Majorants come from the detached density with `bloat` slack (gradient
    rendering needs a null-collision probability > 0 everywhere;
    grids/majorant.build_majorants). pack=True builds the fused rows (8
    wide) and the temperature corner rows too, from detached data: the
    replay gradient never differentiates through them. pack=False makes no
    copy: the dense kernels read the leaves' arrays themselves (the
    temperature leaf, and softplus of the log-density).
    """
    density = dataclasses.replace(base.density, data=density_from_param(grids.log_density))
    temperature = base.temperature
    if grids.temperature is not None and base.temperature is not None:
        temperature = dataclasses.replace(base.temperature, data=grids.temperature)
    majorants = build_majorants(density, bloat=bloat)
    return Medium(
        density=density,
        majorants=majorants,
        temperature=temperature,
        density_rows=pack_fused_rows(density.data.detach(), majorants) if pack else None,
        temperature_rows=(pack_corner_rows(temperature.data.detach())
                          if (pack and temperature is not None) else None),
    )


def make_render_loss(
    base_medium: Medium,
    params: IntegratorParams,
    camera: Camera,
    bb_table,
    n_iters: int,
    use_jitter: bool,
    samples_per_step: int = 4,
    use_prb: bool = True,
    pack: bool = False,
    dual_buffer: bool = False,
):
    """loss(grids, raster, pids, target_px, seed_wave) -> (sum_sq, n).

    Renders `samples_per_step` = k independent waves of the pixel batch as
    one flat ray batch (waves seed_wave[1] * k + i of seed seed_wave[0]) and
    compares the per-pixel mean with the target: averaging k samples cuts
    the Monte Carlo noise floor of the loss k-fold. dual_buffer=True (k >=
    2) splits the samples into halves A and B and uses sum((A - t) * (B -
    t)), whose expectation is the squared error of the mean without the
    variance term, so its gradient is unbiased (the variance term's gradient
    pulls toward low-variance parameters, visibly for blackbody emission).

    use_prb=True differentiates through the path replay (trace_rays_prb,
    truncating at n_iters, and pack=True may use the fused rows);
    use_prb=False through the autograd oracle (integrator.trace_rays_diff).
    Returns the batch's sum and count (n = pixels * 3, a float).
    target_px: [N, 3] target film XYZ (imaging_ratio-scaled means).
    """
    k = samples_per_step
    if dual_buffer and k < 2:
        raise ValueError("dual_buffer needs samples_per_step >= 2")
    if use_prb:
        # The replay truncates at params.max_iters; mirror the loop's bound.
        params = dataclasses.replace(params, max_iters=n_iters)

    def loss_fn(grids: OptimizableGrids, raster, pids, target_px, seed_wave):
        with span("train.rebuild"):
            medium = medium_with_params(base_medium, grids, pack=pack and use_prb)
        n = pids.shape[0]
        with span("train.rays"):
            o_w, d_w, pids_k, stream_k = loss_rays(camera, raster, pids, seed_wave, k, use_jitter)
        if use_prb:
            L = trace_rays_prb(medium, params, bb_table, o_w, d_w, pids_k, stream_k)
        else:
            L = trace_rays_diff(medium, params, bb_table, o_w, d_w, pids_k, stream_k, n_iters)
        Lk = camera.imaging_ratio * L.reshape(k, n, 3)
        if dual_buffer:
            a = Lk[: k // 2].mean(dim=0) - target_px
            b = Lk[k // 2:].mean(dim=0) - target_px
            sq = (a * b).sum()
        else:
            sq = ((Lk.mean(dim=0) - target_px) ** 2).sum()
        return sq, float(n * 3)

    return loss_fn


def make_train_step(
    base_medium: Medium,
    params: IntegratorParams,
    camera: Camera,
    bb_table,
    n_iters: int = 512,
    use_jitter: bool = True,
    mesh: Optional[Mesh] = None,
    samples_per_step: int = 4,
    use_prb: bool = True,
    pack: bool = False,
    dual_buffer: bool = False,
):
    """step(grids, opt, raster, pids, target_px, seed_wave) -> (grids, opt,
    loss): the loss's gradient over its count into torch.optim.Adam (`opt`,
    from make_optimizer over `grids`' tensors, which are updated in place).
    `loss` is a 0-d tensor; nothing waits for the device. dual_buffer: see
    make_render_loss.

    With a mesh (the counterpart of the JAX package's shard_map step) the
    batch's N rows split into R contiguous shards (N a multiple of R); cell
    (r, s) takes shard r at seed-wave (seed, wave * S + s) on its device,
    and its own backward gives its gradients on the grids' device. The
    gradients and the squared error are summed over this process's cells
    (shard.tree_sum), then across processes (torch.distributed.all_reduce),
    before the update: loss = sum / n and gradient / n, n the count over
    every cell.
    """
    make_loss = functools.partial(
        make_render_loss, params=params, n_iters=n_iters, use_jitter=use_jitter,
        samples_per_step=samples_per_step, use_prb=use_prb, pack=pack, dual_buffer=dual_buffer,
    )
    if mesh is not None:
        return _sharded_train_step(mesh, base_medium, camera, bb_table, make_loss)
    loss_fn = make_loss(base_medium, camera=camera, bb_table=bb_table)

    def train_step(grids: OptimizableGrids, opt: torch.optim.Adam, raster, pids, target_px, seed_wave):
        with span("train.step"):
            with span("train.optimizer"):
                opt.zero_grad(set_to_none=True)
            sq, n = loss_fn(grids, raster, pids, target_px, seed_wave)
            with span("train.backward"):
                sq.backward()
            leaves = grid_leaves(grids)
            _update(opt, leaves, [p.grad for p in leaves], n)
            return grids, opt, sq.detach() / n

    return train_step


def _update(opt: torch.optim.Adam, leaves, grads, n: float):
    """The step's update: each leaf's gradient `grads` (None: it has none)
    over the loss's count n, then opt.step()."""
    with span("train.optimizer"):
        for p, g in zip(leaves, grads):
            # optax updates a leaf with no gradient as one with a zero gradient
            p.grad = torch.zeros_like(p) if g is None else g.div_(n)
        opt.step()


def _sharded_train_step(mesh: Mesh, base_medium: Medium, camera: Camera, bb_table, make_loss):
    R, S = mesh.shape["rays"], mesh.shape["spp"]
    losses = {}  # device -> the loss of a cell there, over the scene's copies on it

    def cell_loss(dev):
        key = str(dev)
        if key not in losses:
            losses[key] = make_loss(to_device(base_medium, dev), camera=to_device(camera, dev),
                                    bb_table=to_device(bb_table, dev))
        return losses[key]

    def train_step(grids: OptimizableGrids, opt: torch.optim.Adam, raster, pids, target_px, seed_wave):
        with span("train.step"):
            with span("train.optimizer"):
                opt.zero_grad(set_to_none=True)
            leaves = grid_leaves(grids)
            n_rays = pids.shape[0]
            if n_rays % R:
                raise ValueError(f"{n_rays} pixels do not split into {R} 'rays' shards (pad the batch)")
            per = n_rays // R
            seed, wave = int(seed_wave[0]), int(seed_wave[1])
            sqs, grads = [], []
            for r, s, dev in mesh.local_cells():
                rows = slice(r * per, (r + 1) * per)
                cell_grids = OptimizableGrids(*(None if x is None else x.to(dev) for x in grids))
                sq, _ = cell_loss(dev)(cell_grids, raster[rows].to(dev), pids[rows].to(dev),
                                       target_px[rows].to(dev), (seed, (wave * S + s) & 0xFFFFFFFF))
                with span("train.backward"):
                    g = torch.autograd.grad(sq, leaves, allow_unused=True)
                sqs.append(sq.detach().to(leaves[0].device))
                grads.append(g)
            sq = tree_sum(sqs)
            # A leaf has no gradient in every cell or in none: the graph is one.
            total = [None if col[0] is None else tree_sum(col) for col in zip(*grads)]
            if mesh.spans_processes:
                for t in (sq, *total):
                    if t is not None:
                        dist.all_reduce(t)
            n = float(per * 3 * mesh.size)
            _update(opt, leaves, total, n)
            return grids, opt, sq / n

    return train_step
