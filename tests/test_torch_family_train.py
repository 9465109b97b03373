"""Port vs JAX package: training the six new architectures — a train step
with a frontend's inputs (``patch_embeds`` split into microbatches) and the
experts' aux loss, the frontends' inputs of ``launch.train`` (the
reference's ``add_frontend_inputs``), the ``launch.train`` command line on
every family's batches, and ``--sparsify`` then ``launch.serve --ckpt-dir``
on the xLSTM's checkpoint.

Reduced configs, float32 compute, on the CPU; weights reach the port through
``repro_torch.convert.from_jax_params``.  Tolerances: losses, aux and grad
norms of a train step rtol 1e-5; parameters after two steps within lr / 10
(``test_torch_train.py`` sets out why Adam's steps are held so); frontend
inputs and served tokens exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.launch.train import add_frontend_inputs as jax_frontend_inputs
from repro.optim import adamw as jadamw
from repro.train.train_loop import make_train_step as jmake_train_step

from _torch_port import (family_batch, family_named, family_setup,
                         to_torch_model)
from repro_torch.configs.base import get_arch
from repro_torch.launch.serve import run_serve
from repro_torch.optim import adamw
from repro_torch.train.train_loop import make_train_step, train_params

NEW_ARCHS = ("olmoe_1b_7b", "llama4_scout_17b_a16e", "internvl2_1b",
             "seamless_m4t_medium", "zamba2_7b", "xlstm_125m")


@pytest.mark.parametrize("arch", ["internvl2_1b", "seamless_m4t_medium"])
def test_frontend_inputs_are_the_reference_ones(arch):
    from repro_torch.launch.train import add_frontend_inputs
    cfg = get_arch(arch)
    toks = np.zeros((2, 16), np.int32)
    want = jax_frontend_inputs(cfg, {"tokens": toks},
                               np.random.default_rng(7))
    got = add_frontend_inputs(cfg, {"tokens": toks}, np.random.default_rng(7))
    assert set(got) == set(want) and len(got) == 2
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


@pytest.mark.parametrize("arch", ["internvl2_1b", "olmoe_1b_7b"])
def test_train_steps_match_the_reference(arch):
    """Two masked train steps with 2 microbatches: the batch's extra keys
    (``patch_embeds``) are split and passed through, and the experts' aux
    loss is averaged over the microbatches, as the reference's step does."""
    jcfg, tcfg, jmodel, jparams = family_setup(arch)
    model = to_torch_model(jparams, tcfg)
    kw = dict(lr=1e-3, total_steps=10, warmup_steps=1)
    jstep = jax.jit(jmake_train_step(jmodel, jadamw.AdamWConfig(**kw),
                                     num_microbatches=2))
    step = make_train_step(model, adamw.AdamWConfig(**kw),
                           num_microbatches=2)
    jp, params = jparams, train_params(model)
    jopt = jadamw.init(jadamw.AdamWConfig(**kw), jp)
    opt = adamw.init(adamw.AdamWConfig(**kw), params)
    for i in range(2):
        batch = family_batch(tcfg, b=4, t=8, seed=i)
        jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v)
                                        for k, v in batch.items()}, i)
        params, opt, m = step(params, opt, batch, i)
        for key in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5, atol=1e-9)
    want = family_named(jp)
    for n, p in params.items():
        np.testing.assert_allclose(p.numpy(), want[n], rtol=0,
                                   atol=kw["lr"] / 10, err_msg=n)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_train_cli_on_every_family(arch, tmp_path):
    """``launch.train --device cpu --arch <family>``: the reduced model
    trains (the launcher checks that the loss falls) on batches with the
    family's inputs; the MoE families report their aux loss."""
    from repro_torch.launch.train import main as train_main
    out = train_main(["--device", "cpu", "--arch", arch, "--steps", "10",
                      "--batch", "8", "--seq", "32", "--lr", "3e-3",
                      "--ckpt-dir", str(tmp_path / "ckpt")])
    assert out["losses"][-1] < out["losses"][0]
    if get_arch(arch).moe is not None:
        assert len(out["aux"]) == 10 and min(out["aux"]) > 0
    else:
        assert out["aux"] in ([], [0.0] * 10)


def test_sparsify_cli_then_serve_the_xlstm_checkpoint(tmp_path):
    """``--sparsify`` finds the xLSTM's sparse linears (mLSTM and sLSTM
    projections), bakes verified masks, and ``launch.serve --ckpt-dir
    --packed`` serves the checkpoint the tokens its parameters give in
    memory."""
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.families import build_model
    from repro_torch.train.train_loop import load_params

    d = str(tmp_path / "ckpt")
    out = train_main(["--device", "cpu", "--arch", "xlstm_125m", "--steps",
                      "8", "--batch", "4", "--seq", "32", "--lr", "3e-3",
                      "--ckpt-dir", d, "--sparsify", "2:16"])
    # one period: 3 mLSTM blocks x (up, wq, wk, wv, down) + the sLSTM's
    # w_in and down (w_if and r are dense)
    assert out["sparse_linears_verified"] == 17
    engine = serve_main(["--device", "cpu", "--arch", "xlstm_125m",
                         "--ckpt-dir", d, "--packed", "--backend",
                         "reference", "--requests", "2", "--max-new", "4",
                         "--max-len", "24"])
    cfg = get_arch("xlstm_125m").reduced()
    model = build_model(cfg, device="cpu", seed=0)
    load_params(model, out["params"])
    mem = run_serve(model, cfg.vocab_size, packed=True, backend="reference",
                    requests=2, max_new=4, max_len=24, device="cpu")
    assert {r.uid: r.output for r in engine.completed} == \
        {r.uid: r.output for r in mem.completed}
