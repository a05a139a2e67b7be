"""The frozen reference (benchmark/reference/) against cmpc_refseg_torch's
plain route in float32 on the CPU at TINY widths: the parameter tree, the
forward's logits and masks, and the train loss's gradients."""

import pytest
import torch

from conftest import tiny

CELLS = {"image": ("cmpc-infer-bs32", "cmpc-train-bs32"),
         "video": ("video-infer-8clips", "video-train-16clips")}


def setup(workload, batch, seed):
    import generate
    import program as prog
    from reference.weights import make_params
    _, conf, mix, *_ = tiny(workload, batch=batch)
    model = conf["model"]
    cfg = prog.port_config(conf, mix)
    dev = torch.device("cpu")
    pool = generate.make_pool(model, mix, seed, dev)
    return model, mix, cfg, make_params(model, seed, dev), pool, dev


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_tree_is_the_programs(kind):
    from check import leaf_items
    from cmpc_refseg_torch.models.model import init_model
    model, _, cfg, params, _, _ = setup(CELLS[kind][0], 2, 5)
    want = {p: tuple(t.shape) for p, t in leaf_items(
        init_model(0, cfg, device="cpu"))}
    assert {p: tuple(t.shape) for p, t in leaf_items(params)} == want


@pytest.mark.parametrize("kind,batch", [("image", 3), ("video", 2)])
def test_forward(kind, batch):
    from cmpc_refseg_torch.models.model import apply_model
    from generate import reference_batch
    from reference import model as ref
    model, _, cfg, params, pool, dev = setup(CELLS[kind][0], batch, 11)
    with torch.no_grad():
        got = apply_model(params, cfg, dict(pool[0]), use_kernels=False)
        want = ref.forward(ref.Ops(), params, model,
                           reference_batch(model, pool[0], slice(None), dev))
    scale = want["up"].abs().max()
    assert (got.up - want["up"]).abs().max() <= 1e-4 * scale
    assert (got.sigm - want["sigm"]).abs().max() <= 1e-5
    for lv, up in want["up_levels"].items():
        assert (got.up_levels[lv] - up).abs().max() \
            <= 1e-4 * up.abs().max()


@pytest.mark.parametrize("kind,batch", [("image", 3), ("video", 2)])
def test_loss_gradients(kind, batch):
    from check import leaf_items
    from cmpc_refseg_torch.models.model import init_model_state
    from cmpc_refseg_torch.train.trainer import (compute_gradients,
                                                 train_state_from_params)
    from generate import reference_batch
    from reference import model as ref
    from reference.flagship import head_of
    from reference.weights import make_params
    model, _, cfg, params, pool, dev = setup(CELLS[kind][1], batch, 13)
    state = train_state_from_params(params, cfg,
                                    init_model_state(cfg, device="cpu"))
    loss_p, _ = compute_gradients(state, cfg, pool[0], use_kernels=False)
    got = {p: t.grad for p, t in leaf_items(state.trainable)}

    params = make_params(model, 13, dev)
    head = head_of(params)
    for _, t in leaf_items(head):
        t.requires_grad_()
    rb = reference_batch(model, pool[0], slice(None), dev)
    total = ref.loss(ref.forward_frozen_backbone(ref.Ops(), params, model, rb,
                                                 block=2), rb["target"],
                     model, head)
    total.backward()
    total = float(total.detach())
    assert abs(float(loss_p) - total) <= 1e-5 * abs(total)
    largest = max(float(t.grad.abs().max()) for _, t in leaf_items(head))
    for path, t in leaf_items(head):
        want = t.grad * (2.0 if "biases" in path else 1.0)
        assert (got[path] - want).abs().max() <= \
            1e-4 * want.abs().max() + 1e-9 * largest, path
