"""The runner of the `train_step` traffic: the program's
selfcorr_tpu_torch.train.step.train_step, the training loop's unit of
work, on a state that init_state builds around the benchmark's weights.

Set-up makes the weights and a pool of distinct device batches with their
per-step draws, then runs the first steps through the window's own call
on the pool's first batches: the first `check_steps` are the ones the
reference follows. The window dispatches steps back to back over the pool,
as the Trainer does between logs, and closes with a synchronize; its rate
is the images of every step over the window's host seconds."""
from __future__ import annotations

import contextlib
import json
import time
from types import SimpleNamespace

import torch

from benchmark.harness import common, compare, costs, inputs
from benchmark.harness import trace as T
from benchmark.harness import weights as W


def _program_state(pcfg, state_dicts, device):
    from selfcorr_tpu_torch.models.meshnet import MeshNet, \
        build_mesh_constants
    from selfcorr_tpu_torch.models.vit import DinoViTS8
    from selfcorr_tpu_torch.train.step import init_state
    constants = build_mesh_constants(pcfg)
    with torch.device("meta"):
        model = MeshNet(pcfg, constants)
        dino = DinoViTS8(img_size=pcfg.img_size,
                         attn_bf16=pcfg.dino_attn_bf16)
    model = W.load_into(model, state_dicts[0], device)
    dino = W.load_into(dino, state_dicts[1], device)
    return init_state(pcfg, constants, device, model=model, dino=dino)


def _first_grads(state) -> dict:
    """Each optimized leaf's gradient as AdamW took it in the first
    update, from its first moment: exp_avg = (1 - beta1) g; zero for a
    leaf the optimizer holds no moment of (it took no gradient)."""
    adamw = state.optimizer.adamw
    beta1 = adamw.param_groups[0]["betas"][0]
    out = {}
    for group in state.optimizer.groups.values():
        for name, p in group:
            m = adamw.state.get(p, {}).get("exp_avg")
            out[name] = (m.detach() / (1.0 - beta1) if m is not None
                         else torch.zeros_like(p)).clone()
    return out


def capture(state, one_step, check: int, keep: bool = True):
    """Run the first `check` steps through `one_step` and keep what the
    reference follows (where `keep`): each step's loss terms, each
    optimized leaf's first gradient as AdamW took it, and the parameters
    after the last of them."""
    aux = []
    for i in range(check):
        m = one_step()
        if keep:
            aux.append({k: v.detach().clone() for k, v in m.items()
                        if k.endswith("loss") or k.startswith("cycle")})
            if i == 0:
                grad = _first_grads(state)
    if not keep:
        return None
    return SimpleNamespace(aux=aux, grad=grad, p3={
        n: p.detach().clone() for n, p in state.model.named_parameters()})


def follow(prog, p0: dict, ref_model, ref_dino, rconst, rcfg, device,
           steps: list, count_flops: bool, world: int | None = None,
           reduce=None):
    """The reference's steps from the weights it holds, each a list of
    shards [(batch, draws as a dict)] (benchmark/reference/train/step.py;
    `world` and `reduce` where the shards are spread over processes),
    then, where `prog` holds the program's capture, the comparison:
    (numbers, notes, the first step's matrix work where `count_flops`),
    or None where it does not."""
    from benchmark.reference.models.meshnet import StepDraws as RDraws
    from benchmark.reference.models.meshnet import device_constants
    from benchmark.reference.train.optim import Optimizer
    from benchmark.reference.train.step import train_step as ref_step
    ref_model.train()
    ref_dino.eval().requires_grad_(False)
    opt = Optimizer(ref_model, rcfg)
    dc = device_constants(rconst, device)
    ref_aux, ref_grad, flops = [], None, None
    b = rcfg.batch_size * rcfg.repeat
    for i, shards in enumerate(steps):
        args = (ref_model, ref_dino, opt, dc,
                [(batch, RDraws(**d)) for batch, d in shards], rcfg, i,
                world, reduce)
        if count_flops and i == 0:
            with costs.count_flops() as counter:
                aux, grads = ref_step(*args)
            flops = (counter.get_total_flops(), costs.attn_flops(rcfg, b))
        else:
            aux, grads = ref_step(*args)
        if prog is not None:
            ref_aux.append({k: float(aux[k]) for k in prog.aux[i]})
            if i == 0:
                ref_grad = {k: grads[k] for k in prog.grad}
        del grads
    if prog is None:
        return None
    prog_aux = [{k: float(v) for k, v in d.items()} for d in prog.aux]
    ref_p3 = {n: p.detach() for n, p in ref_model.named_parameters()}
    numbers, notes = compare.train_numbers(
        prog_aux, ref_aux, prog.grad, ref_grad,
        {k: prog.p3[k] - p0[k] for k in prog.grad},
        {k: ref_p3[k] - p0[k] for k in prog.grad})
    lines = [f"total loss of the first {len(steps)} steps: program "
             f"{[a['total_loss'] for a in prog_aux]}, reference "
             f"{[a['total_loss'] for a in ref_aux]}"]
    lines += [f"{k}: {v}" for k, v in notes.items()]
    return numbers, lines, flops


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        readers: dict, flag_overrides: dict | None = None) -> SimpleNamespace:
    clock = common.SetupClock(t0)
    tr = cell.traffic
    flags = common.flag_values(cell, flag_overrides)
    import selfcorr_tpu_torch.train.step as step_mod
    from selfcorr_tpu_torch.models.meshnet import StepDraws
    pcfg, rcfg = common.program_config(flags), common.reference_config(flags)
    clock.mark("import", device)
    if device.type == "cuda":
        torch.zeros((), device=device)
    clock.mark("cuda_init", device)
    if device.type == "cuda":
        from selfcorr_tpu_torch.ops import attention
        from selfcorr_tpu_torch.ops.rasterizer import kernel
        kernel.build()
        attention.build()
    clock.mark("kernel_load", device)

    from benchmark.reference.models.meshnet import build_mesh_constants
    rconst = build_mesh_constants(rcfg)
    ref_model, ref_dino = W.reference_modules(rcfg, rconst, seed, device)
    clock.mark("weights", device)
    state = _program_state(pcfg, (ref_model.state_dict(),
                                  ref_dino.state_dict()), device)
    p0 = {n: p.detach().clone() for n, p in ref_model.named_parameters()}
    clock.mark("program_state", device)

    b = rcfg.batch_size * rcfg.repeat
    pool = inputs.train_pool(tr["pool_batches"], rcfg.batch_size,
                             rcfg.repeat, tr["videos"],
                             tr["frames_per_video"], rcfg.img_size, seed,
                             device)
    chamfer = rcfg.use_depth and rcfg.depth_loss_chamfer
    draws = [inputs.step_draws(seed, i, b, rcfg.symmetry_npts, chamfer)
             for i in range(tr["pool_batches"])]
    clock.mark("inputs", device)

    n_pool = len(pool)
    before = common.launches()
    done = [0]
    bads = []

    def one_step():
        i = done[0] % n_pool
        m = step_mod.train_step(state, pool[i], StepDraws(**draws[i]), pcfg)
        bads.append(m["bad_grad"])
        done[0] += 1
        return m

    prog = capture(state, one_step, tr["check_steps"])
    for _ in range(tr["warmup_steps"] - tr["check_steps"]):
        one_step()
    clock.mark("warmup", device)

    out = SimpleNamespace(setup_s=clock.total(),
                          setup_parts=dict(clock.parts), metrics={},
                          per_layer={}, breakdown=None, busy_s=None,
                          window_s=None, notes=[])
    n0 = done[0]
    spans = common.spans_for(readers) if trace else None
    with (spans.active() if trace else contextlib.nullcontext()):
        start = time.perf_counter()
        while True:
            one_step()
            if time.perf_counter() - start >= seconds:
                break
        common.sync(device)
        window = time.perf_counter() - start
    out.attempted = done[0] - n0
    if not trace:
        out.metrics["train_imgs_per_s"] = out.attempted * b / window
    else:
        l0 = common.launches()

        def profiled():
            for _ in range(tr["profile_steps"]):
                one_step()
            common.sync(device)
        prof = T.profile(profiled)
        out.notes.append(common.trace_launches(prof, l0, common.launches()))
    out.memory_peak = common.memory_peak(device)
    out.failed = int(torch.stack(bads).sum())
    off, line = common.launches_off(before, common.launches(), done[0],
                                    tr["launches_per_unit"], device)
    out.notes.append(line)
    del state
    common.free(device)

    # the reference, once the window has closed and the program is freed
    t_ref = time.perf_counter()
    numbers, lines, flops = follow(
        prog, p0, ref_model, ref_dino, rconst, rcfg, device,
        [[(pool[i], draws[i])] for i in range(tr["check_steps"])], trace)
    numbers["launches_off"] = off
    out.numbers = numbers
    out.reference_s = time.perf_counter() - t_ref
    out.notes += lines
    out.notes.append("numbers: " + json.dumps(numbers))

    if trace:
        ctx = common.LayerContext(
            spans=spans.ms(), captured=spans.captured, units=out.attempted,
            span_s=window, trace=prof, flops=flops, cfg=rcfg)
        common.read_layers(readers, ctx, out)
    return out
