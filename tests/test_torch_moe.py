"""Port vs JAX package: the experts (``models/moe.py``: router, top-k with
renormalised gates, the Switch aux loss, sort-based dispatch with capacity
drops, the experts' FFN and the combine) and the two decoder families that
differ from the dense one in their inputs or their feed-forward: MoE
(``olmoe_1b_7b``, ``llama4_scout_17b_a16e``) and the vision stub
(``internvl2_1b``, patch embeddings in front of the tokens).

The same inputs, made with numpy from a seed, go through the JAX function and
its port on the CPU; weights reach the port through
``repro_torch.convert.from_jax_params``.  Reduced configs, float32 compute.
Tolerances: the experts' output and gradients rtol/atol 1e-5 (the port sums
a token's k contributions in (token, choice) order, the reference in expert
order; ``ROADMAP.md`` Queue 3); the aux loss rtol 1e-6; ``train_loss`` rtol
1e-5, its gradients as ``test_torch_train.py`` holds them; prefill and
decode logits rtol/atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.core.sparse_linear import ExecPolicy as JPolicy
from repro.models import moe as jmoe

from _torch_port import (PACK_MODES, assert_grads_close, decode_both,
                         family_batch, family_setup,
                         loss_and_grads_both, to_torch_model, torch_batch)
from repro_torch.configs.base import MoEConfig
from repro_torch.core.pruning import top_k_stable
from repro_torch.core.sparse_linear import ExecPolicy, SparseLinear
from repro_torch.models import moe as tmoe

TOL = dict(rtol=1e-4, atol=1e-4)
D, F = 16, 32

# (experts, top-k, capacity factor, capacity override, zero router)
MOE_CASES = {
    "default": (4, 2, 1.25, None, False),
    "drops": (8, 2, 0.5, None, False),         # capacity 1 of 10 tokens
    "no_drop": (4, 2, 1.25, 20, False),        # room for every pair
    "ties": (4, 2, 1.25, None, True),          # uniform router: all tied
    "top_1": (4, 1, 1.25, None, False),
}


def _moe(case, seed=0):
    e, k, cf, cap, zero = MOE_CASES[case]
    jcfg = JMoEConfig(e, k, F, capacity_factor=cf)
    tcfg = MoEConfig(e, k, F, capacity_factor=cf)
    params = jmoe.init_moe(jax.random.PRNGKey(seed), D, jcfg)
    if zero:
        params["router"] = {"w": jnp.zeros_like(params["router"]["w"])}
    np_p = jax.tree.map(np.asarray, params)
    port = tmoe.MoE(SparseLinear(torch.from_numpy(np_p["router"]["w"])),
                    *(torch.from_numpy(np_p[n])
                      for n in ("w_gate", "w_up", "w_down")))
    x = np.random.default_rng(seed).standard_normal((2, 5, D)).astype(
        np.float32)
    return jcfg, tcfg, params, port, x, cap


def test_top_k_breaks_ties_to_the_lower_index():
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 4, (64, 16)).astype(np.float32)   # many ties
    want_v, want_i = jax.lax.top_k(jnp.asarray(scores), 5)
    got_v, got_i = top_k_stable(torch.from_numpy(scores), 5)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_apply_moe_local_matches(case):
    """Output, aux loss and the gradients at x and every weight (of
    sum(y * r) + aux), against ``jax.grad`` of the reference's."""
    jcfg, tcfg, params, port, x, cap = _moe(case)
    r = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)

    def jf(p, xx):
        y, aux = jmoe._apply_moe_local(p, xx, jcfg, capacity=cap)
        return jnp.sum(y * r) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    class Run(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.moe = port

        def forward(self, xx):
            return tmoe._apply_moe_local(self.moe, xx, tcfg, capacity=cap)

    tx = torch.from_numpy(x).requires_grad_(True)
    leaves = {n: p.clone().requires_grad_(True)
              for n, p in Run().named_parameters()}
    ty, taux = torch.func.functional_call(Run(), leaves, (tx,))
    (torch.sum(ty * torch.from_numpy(r)) + taux).backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert float(taux) > 0
    grads = {n[len("moe."):]: t.grad.numpy() for n, t in leaves.items()}
    want = {"router.w": np.asarray(jgp["router"]["w"]),
            **{n: np.asarray(jgp[n]) for n in ("w_gate", "w_up", "w_down")}}
    if MOE_CASES[case][1] == 1:
        # at k = 1 the renormalised gate is g / g = 1: the main loss's
        # gradient at the router cancels to float32 rounding on both sides
        # (some 5e-7 here), and only the aux loss's part is signal
        np.testing.assert_allclose(grads.pop("router.w"),
                                   want.pop("router.w"), rtol=1e-5,
                                   atol=2e-6)
    assert_grads_close(grads, want)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               rtol=1e-5, atol=1e-5 * np.abs(jgx).max())


def test_capacity_drops_and_ties_route_as_the_reference():
    """With a uniform router every token's top-k is experts 0..k-1 (ties to
    the lower index); at capacity 2 only each expert's first two pairs in
    token order are kept, the rest of the tokens get 0."""
    _, tcfg, _, port, x, _ = _moe("ties")
    y, _ = tmoe._apply_moe_local(port, torch.from_numpy(x), tcfg, capacity=2)
    rows = y.reshape(10, D)
    assert rows[:2].abs().sum(-1).min() > 0
    assert torch.equal(rows[2:], torch.zeros_like(rows[2:]))
    assert tmoe.capacity_of(tcfg, 10) == 6
    assert tmoe.capacity_of(MoEConfig(64, 8, 1024), 4) == 1   # "or 1"


def test_moe_output_does_not_depend_on_the_order_of_equal_runs():
    """The combine is deterministic: the same call twice gives the same
    bits (no scatter-add)."""
    _, tcfg, _, port, x, _ = _moe("default")
    a = tmoe._apply_moe_local(port, torch.from_numpy(x), tcfg)[0]
    b = tmoe._apply_moe_local(port, torch.from_numpy(x), tcfg)[0]
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the families: olmoe, llama4_scout (experts), internvl2 (vision stub)
# ---------------------------------------------------------------------------

ARCHS = ("olmoe_1b_7b", "llama4_scout_17b_a16e", "internvl2_1b")


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    return (request.param, *family_setup(request.param))


def test_train_loss_aux_and_grads_match(family):
    arch, jcfg, tcfg, jmodel, params = family
    batch = family_batch(tcfg, t=12)
    (loss, met, grads), (jloss, jmet, jgrads) = loss_and_grads_both(
        jmodel, params, to_torch_model(params, tcfg), batch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert set(met) == set(jmet) == {"xent", "aux"}
    np.testing.assert_allclose(met["xent"], jmet["xent"], rtol=1e-5)
    np.testing.assert_allclose(met["aux"], jmet["aux"], rtol=1e-5,
                               atol=1e-9)
    assert (met["aux"] > 0) == (tcfg.moe is not None)
    assert_grads_close(grads, jgrads)


def test_prefill_matches(family):
    arch, jcfg, tcfg, jmodel, params = family
    batch = family_batch(tcfg, t=12, seed=2)
    del batch["targets"]
    jlogits, _ = jmodel.prefill(
        params, {k: jnp.asarray(v) for k, v in batch.items()},
        policy=JPolicy(mode="masked"))
    tmodel = to_torch_model(params, tcfg)
    with torch.inference_mode():
        logits, state = tmodel.prefill(torch_batch(batch),
                                       policy=ExecPolicy(mode="masked"))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert state["pos"].tolist() == [0, 0]


# every mode for olmoe; the others share its code past the config
DECODE_CASES = ([("olmoe_1b_7b", m) for m in PACK_MODES]
                + [("llama4_scout_17b_a16e", "packed"),
                   ("internvl2_1b", "masked"),
                   ("internvl2_1b", "packed_block_int8")])


@pytest.mark.parametrize("arch,mode", DECODE_CASES)
def test_decode_steps_match(arch, mode):
    jcfg, tcfg, jmodel, params = family_setup(arch)
    steps, tstate, jstate, _ = decode_both(jmodel, params, tcfg, mode,
                                           steps=2)
    for got, want in steps:
        np.testing.assert_allclose(got, want, **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tstate["caches"][key].numpy(),
                                   np.asarray(jstate["caches"][key]), **TOL)


def test_vision_loss_skips_the_patch_positions():
    """The patches change the text positions' logits (they are attended
    to) but carry no loss: targets are (B, T) for (B, P + T) positions."""
    _, tcfg, _, params = family_setup("internvl2_1b")
    tmodel = to_torch_model(params, tcfg)
    batch = torch_batch(family_batch(tcfg, t=6))
    assert batch["patch_embeds"].shape[1] == tcfg.num_patches
    with torch.no_grad():
        a = tmodel.train_loss(batch)[1]["xent"]
        batch["patch_embeds"] = batch["patch_embeds"] * 2
        b = tmodel.train_loss(batch)[1]["xent"]
    assert float(a) != float(b)
    with pytest.raises(KeyError):
        tmodel.train_loss({k: v for k, v in batch.items()
                           if k != "patch_embeds"})
