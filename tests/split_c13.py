"""The split of ROADMAP C.13: the one-device train step of the port against
the JAX package's on the two 4-row shards of np_batch(seed=3, b=8) (keys
fold_in(PRNGKey(7), r)), the inputs of tests/test_torch_parallel.py.

For each shard it prints, for every parameter leaf whose gradient misses
tests/test_torch_train_step.py's bound (2e-3 of the leaf's largest entry),
the miss as a multiple of the bound, and which aux loss terms carry it (each
term backpropagated alone in both packages; JAX: forward_train and a VJP,
the Pallas rasterizer in interpret mode). It then prints the same misses
for the port with oneDNN off (another f32 convolution and matmul path)
against the port and against JAX, with oneDNN off in the backbone's
forward only against JAX, for the port at 1 CPU thread against the port,
the aux losses' largest move between 1 and all threads with oneDNN on and
off, and the symmetry loss of each run; then how far the backbone's f32
convolutions lie from float64 with oneDNN and without.

    python tests/split_c13.py            # ~2 min on 8 CPU cores

It is a script, not a test (pytest does not collect it).
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from selfcorr_tpu.configs import Config as JConfig  # noqa: E402
from selfcorr_tpu.models import meshnet as JM  # noqa: E402
from selfcorr_tpu.ops.rasterizer import pallas_raster as PR  # noqa: E402
from selfcorr_tpu.train.step import init_state as jax_init_state  # noqa
from selfcorr_tpu_torch.configs import Config  # noqa: E402
from selfcorr_tpu_torch.models.meshnet import (MeshNet,  # noqa: E402
                                               build_mesh_constants,
                                               forward_train)
from selfcorr_tpu_torch.models.vit import DinoViTS8  # noqa: E402
from selfcorr_tpu_torch.train.step import init_state  # noqa: E402
from selfcorr_tpu_torch.utils import weight_convert as W  # noqa: E402
from test_torch_train_step import TINY, jax_draws, np_batch  # noqa: E402

TERMS = ["mask_loss", "texture_loss", "match_loss", "imatch_loss",
         "depth_loss", "symmetry_loss", "triangle_loss", "pullfar_loss",
         "deform_loss", "cycle_loss_pretrain", "cycle_loss"]


def jax_split(state, constants, jcfg, batch, rng):
    """[{aux, per-term state-dict gradients}] of both shards."""
    bs = jax.tree_util.tree_map(np.asarray, state.batch_stats)

    def f(params, shard, key, cot):
        def aux_fn(p):
            return JM.forward_train(p, state.batch_stats, state.dino_params,
                                    shard, constants, key, jcfg, 0)[1][0]
        aux, vjp = jax.vjp(aux_fn, params)
        return aux, vjp({k: cot.get(k, jnp.zeros(())) for k in aux})[0]
    f = jax.jit(f)
    out = []
    for r in range(2):
        shard = {k: v[4 * r: 4 * (r + 1)] for k, v in batch.items()}
        key = jax.random.fold_in(rng, r)
        per = {}
        for n in TERMS:
            aux, g = f(state.params, shard, key,
                       {m: jnp.float32(m == n) for m in TERMS})
            per[n] = W.from_jax_params(
                jax.tree_util.tree_map(np.asarray, g), bs)
        out.append(dict(aux={k: float(v) for k, v in aux.items()}, per=per))
    return out


def without_onednn(module):
    """Run `module`'s forward with oneDNN off (its backward follows)."""
    forward = module.forward

    def wrapped(*a, **k):
        with torch.backends.mkldnn.flags(enabled=False):
            return forward(*a, **k)
    module.forward = wrapped


def conv_errors():
    """Largest |f32 - f64| of the backbone's convolution shapes (batch 4
    at img 32) with oneDNN and without, over the f64 result's scale."""
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(0)
    out = []
    for cin, cout, size, k, stride in ((3, 64, 32, 7, 2), (64, 64, 8, 3, 1),
                                       (128, 128, 4, 3, 1),
                                       (256, 256, 2, 3, 1),
                                       (512, 512, 1, 3, 1)):
        x = torch.randn((4, cin, size, size), generator=g)
        w = torch.randn((cout, cin, k, k), generator=g) * 0.05
        ref = F.conv2d(x.double(), w.double(), stride=stride, padding=k // 2)
        errs = []
        for on in (True, False):
            with torch.backends.mkldnn.flags(enabled=on):
                y = F.conv2d(x, w, stride=stride, padding=k // 2)
            errs.append(float((y.double() - ref).abs().max())
                        / float(ref.abs().max()))
        out.append(((cin, cout, size, k), *errs))
    return out


def port_split(state, batch, rng, r, backbone_without_onednn=False):
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    cfg = Config(device="cpu", **TINY)
    pconst = build_mesh_constants(cfg)
    model = MeshNet(cfg, pconst)
    model.load_state_dict(W.from_jax_params(to_np(state.params),
                                            to_np(state.batch_stats)))
    dino = DinoViTS8(img_size=32, attn_bf16=False)
    dino.load_state_dict(W.from_jax_dino_params(to_np(state.dino_params)))
    st = init_state(cfg, pconst, "cpu", model=model, dino=dino)
    if backbone_without_onednn:
        without_onednn(st.model.encoder.backbone)
    shard = {k: torch.tensor(v[4 * r: 4 * (r + 1)]) for k, v in batch.items()}
    draws = jax_draws(jax.random.fold_in(rng, r), 4, cfg.symmetry_npts)
    _, aux = forward_train(st.model, st.dino, shard, st.constants, cfg, 0,
                           draws)
    per = {}
    for n in TERMS:
        st.model.zero_grad(set_to_none=True)
        if aux[n].requires_grad:
            aux[n].backward(retain_graph=True)
        per[n] = {k: (p.grad.clone() if p.grad is not None
                      else torch.zeros_like(p))
                  for k, p in st.model.named_parameters()}
    return dict(aux={k: float(v.detach()) for k, v in aux.items()},
                per=per)


def misses(got, ref, top=6):
    """[(miss / bound, leaf, {term: miss / bound})] of the total
    gradients, largest first."""
    leaves = list(got["per"][TERMS[0]])
    out = []
    for k in leaves:
        tg = sum(np.asarray(got["per"][n][k]) for n in TERMS)
        tr = sum(np.asarray(ref["per"][n][k]) for n in TERMS)
        lim = max(2e-3 * float(np.abs(tr).max()), 1e-7)
        err = float(np.abs(tg - tr).max())
        if err > lim:
            out.append((err / lim, k, {
                n: float(np.abs(np.asarray(got["per"][n][k])
                                - np.asarray(ref["per"][n][k])).max()) / lim
                for n in TERMS}))
    return sorted(out, key=lambda x: -x[0])[:top]


def show(title, rows):
    print(title)
    for ratio, k, terms in rows:
        carriers = sorted(terms.items(), key=lambda x: -x[1])[:3]
        print(f"  {ratio:7.2f}x  {k}: " + ", ".join(
            f"{n} {v:.2f}" for n, v in carriers))
    if not rows:
        print("  (every leaf within the bound)")


def main():
    PR.COMPACT = True
    jcfg = JConfig(use_pallas=True, **TINY)
    constants = JM.build_mesh_constants(jcfg)
    state = jax.jit(lambda k: jax_init_state(jcfg, constants, k))(
        jax.random.PRNGKey(0))
    batch = np_batch(seed=3, b=8)
    rng = jax.random.PRNGKey(7)
    ref = jax_split(state, constants, jcfg, batch, rng)
    threads = torch.get_num_threads()
    for r in range(2):
        base = port_split(state, batch, rng, r)
        show(f"shard {r}: port ({threads} threads) against JAX",
             misses(base, ref[r]))
        with torch.backends.mkldnn.flags(enabled=False):
            off = port_split(state, batch, rng, r)
        show(f"shard {r}: port with oneDNN off against the port",
             misses(off, base))
        show(f"shard {r}: port with oneDNN off against JAX",
             misses(off, ref[r]))
        show(f"shard {r}: port with oneDNN off in the backbone's forward "
             f"only, against JAX",
             misses(port_split(state, batch, rng, r, True), ref[r]))
        torch.set_num_threads(1)
        one = port_split(state, batch, rng, r)
        torch.set_num_threads(threads)
        show(f"shard {r}: port at 1 thread against the port",
             misses(one, base))
        with torch.backends.mkldnn.flags(enabled=False):
            torch.set_num_threads(1)
            off_one = port_split(state, batch, rng, r)
            torch.set_num_threads(threads)
        for tag, x, y in (("oneDNN on", one, base), ("oneDNN off", off_one,
                                                      off)):
            moved = max(abs(x["aux"][k] - y["aux"][k]) for k in TERMS)
            print(f"  {tag}: largest aux-loss difference between 1 and "
                  f"{threads} threads {moved:.3g}")
        sym = ref[r]["aux"]["symmetry_loss"]
        print(f"  symmetry loss: JAX {sym:.9g}; port {threads} threads "
              f"{base['aux']['symmetry_loss']:.9g}, 1 thread "
              f"{one['aux']['symmetry_loss']:.9g}, oneDNN off "
              f"{off['aux']['symmetry_loss']:.9g}")
    print("f32 convolutions against f64, |diff| over scale (oneDNN, "
          "native):")
    for shape, on, native in conv_errors():
        print(f"  (cin, cout, size, k) {shape}: {on:.2e}, {native:.2e}")


if __name__ == "__main__":
    main()
