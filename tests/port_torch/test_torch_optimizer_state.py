"""The optimizer state in ``-last.ckpt`` against the JAX package's optax
state (``optax.multi_transform`` of Adam or AdamW over the ``backbone`` and
``head`` groups): a state that the JAX package wrote takes one Adam step in
the port as in optax, in float64; and the port's state goes through the JAX
package's checkpoint and optax structure and back bitwise. The models cover
every layout the moments share with their parameters: convolutions (OIHW
against HWIO), the heatmap head's flipped transposed convolutions, the
context head's regrouped kernels, the ViT's 3-d ``DenseGeneral`` kernels
and its linear layers."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.usefixtures("few_torch_threads")

IMAGE = 64
KEYPOINTS = 3
SPE = 4
# a narrow ViT-S for the CPU: (embed_dim, depth, num_heads, patch)
SMALL_VIT = (64, 2, 2, 16)
# float64 on both sides: the update and the new moments within this share of
# their largest entry
F64_RTOL = 1e-6

CASES = [
    ("heatmap", "resnet18", "Adam"),
    ("heatmap_mhcrnn", "resnet18", "AdamW"),
    ("heatmap_multiview", "vits_dino", "Adam"),
]


@pytest.fixture()
def small_vit(monkeypatch):
    from lightning_pose_tpu.models.backbones import vit as jax_vit
    from lightning_pose_tpu_torch.models.backbones import vit

    monkeypatch.setitem(jax_vit.VIT_CONFIGS, "vits", SMALL_VIT)
    monkeypatch.setitem(vit.VIT_CONFIGS, "vits", SMALL_VIT)


def _cfg(model_type: str, backbone: str, optimizer: str):
    """Epoch mode, the backbone unfrozen from epoch 0, a milestone at 1."""
    from lightning_pose_tpu_torch.config import load_config

    cfg = load_config()
    cfg.data.num_keypoints = KEYPOINTS
    cfg.data.keypoint_names = [f"kp{i}" for i in range(KEYPOINTS)]
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = IMAGE
    cfg.model.model_type = model_type
    cfg.model.backbone = backbone
    if model_type == "heatmap_multiview":
        cfg.data.view_names = ["top", "side"]
        cfg.data.csv_file = ["top.csv", "side.csv"]
    t = cfg.training
    t.optimizer = optimizer
    t.max_epochs = t.min_epochs = 3
    t.unfreezing_epoch = 0
    t.lr_scheduler_params.multisteplr.milestones = [1]
    return cfg


def _dummy(model_type: str):
    if model_type == "heatmap_mhcrnn":
        return jnp.zeros((1, 5, IMAGE, IMAGE, 3))
    if model_type == "heatmap_multiview":
        return jnp.zeros((1, 2, IMAGE, IMAGE, 3))
    return jnp.zeros((1, IMAGE, IMAGE, 3))


def _grads(params, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda p: rng.standard_normal(np.shape(p)) * 0.1, params)


def _leaves(tree) -> list[np.ndarray]:
    """The array leaves of a state dict, in order (optax's masked leaves,
    written ``{}``, have none)."""
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("model_type, backbone, optimizer", CASES)
def test_one_step_from_a_jax_last_ckpt_equals_optax(model_type, backbone, optimizer, small_vit,
                                                    seeded_jax_variables, tmp_path):
    import flax.serialization
    import optax

    from lightning_pose_tpu.models.factory import get_model as jax_get_model
    from lightning_pose_tpu.train import checkpoints as jax_ckpt
    from lightning_pose_tpu.train import trainer as jtrainer
    from lightning_pose_tpu_torch.models.factory import get_model
    from lightning_pose_tpu_torch.train import checkpoints as ckpt
    from lightning_pose_tpu_torch.train import trainer

    cfg = _cfg(model_type, backbone, optimizer)
    path = str(tmp_path / "epoch=0-step=2-last.ckpt")
    with jax.enable_x64(True):
        module, _ = jax_get_model(cfg, num_keypoints=KEYPOINTS, compute_dtype=jnp.float64)
        variables = seeded_jax_variables(module, _dummy(model_type), seed=1, train=False)
        params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables["params"])
        stats = variables.get("batch_stats", {})
        tx, _, _ = jtrainer.make_optimizer(cfg, SPE, params)
        update = jax.jit(tx.update)
        opt_state = tx.init(params)
        for seed in (2, 3):  # moments away from zero, the counts at 2
            updates, opt_state = update(_grads(params, seed), opt_state, params)
            params = jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, updates))
        jax_ckpt.save_checkpoint(path, params, stats, step=2, epoch=0, opt_state=opt_state)
        grads = _grads(params, 4)
        updates, new_state = update(grads, opt_state, params)
        ref_update = jax.tree_util.tree_map(np.asarray, updates)
        ref_state = flax.serialization.to_state_dict(jax.tree_util.tree_map(np.asarray, new_state))

    loaded = ckpt.load_checkpoint(path)
    model = get_model(cfg, num_keypoints=KEYPOINTS).double()
    ckpt.load_flax_variables(model, loaded["params"], loaded["batch_stats"])
    optimizer_, head_sched, bb_sched = trainer.make_optimizer(cfg, SPE, model)
    assert ckpt.load_optimizer_state_from_flax(model, optimizer_, loaded["opt_state"]) == 2
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for name, grad in ckpt.state_dict_from_flax(grads, {}).items():
        dict(model.named_parameters())[name].grad = grad
    trainer.set_learning_rates(optimizer_, 2, head_sched, bb_sched)
    optimizer_.step()

    out_update = ckpt.state_dict_to_flax({n: p.detach() - before[n] for n, p in model.named_parameters()})[0]
    ref_leaves, out_leaves = _leaves(ref_update), _leaves(out_update)
    assert len(ref_leaves) == len(out_leaves) and len(ref_leaves) > 10
    scale = max(np.abs(x).max() for x in ref_leaves)
    assert scale > 1e-5  # the backbone unfrozen: every group moves
    for ref, out in zip(ref_leaves, out_leaves):
        np.testing.assert_allclose(out, ref, rtol=0, atol=F64_RTOL * scale)
    ref_moments, out_moments = _leaves(ref_state), _leaves(ckpt.optimizer_state_to_flax(model, optimizer_))
    assert len(ref_moments) == len(out_moments)
    for ref, out in zip(ref_moments, out_moments):
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=0, atol=F64_RTOL * max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("model_type, backbone, optimizer", [CASES[1], CASES[2]])
def test_the_port_state_round_trips_through_the_jax_package_bitwise(model_type, backbone, optimizer, small_vit,
                                                                    tmp_path):
    """The port's ``-last.ckpt`` -> the JAX package's ``load_checkpoint`` and
    ``from_state_dict`` onto its optax state (the structure must match
    exactly) -> its ``save_checkpoint`` -> the port: the same moments and
    counts, bit for bit."""
    import flax.serialization

    from lightning_pose_tpu.train import checkpoints as jax_ckpt
    from lightning_pose_tpu.train import trainer as jtrainer
    from lightning_pose_tpu_torch.models.factory import get_model
    from lightning_pose_tpu_torch.train import checkpoints as ckpt
    from lightning_pose_tpu_torch.train import trainer

    cfg = _cfg(model_type, backbone, optimizer)
    torch.manual_seed(0)
    model = get_model(cfg, num_keypoints=KEYPOINTS)
    optimizer_, head_sched, bb_sched = trainer.make_optimizer(cfg, SPE, model)
    gen = torch.Generator().manual_seed(1)
    for step in range(3):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        trainer.set_learning_rates(optimizer_, step, head_sched, bb_sched)
        optimizer_.step()
    port_path = str(tmp_path / "port-last.ckpt")
    ckpt.save_module(port_path, model, step=3, epoch=0, optimizer=optimizer_)

    loaded = jax_ckpt.load_checkpoint(port_path)
    template = jtrainer.make_optimizer(cfg, SPE, loaded["params"])[0].init(loaded["params"])
    restored = flax.serialization.from_state_dict(template, loaded["opt_state"])
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(template)
    for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(template)):
        assert np.shape(a) == np.shape(b) and np.asarray(a).dtype == np.asarray(b).dtype
    jax_path = str(tmp_path / "jax-last.ckpt")
    jax_ckpt.save_checkpoint(jax_path, loaded["params"], loaded["batch_stats"], 3, 0, opt_state=restored)

    back = ckpt.load_checkpoint(jax_path)
    fresh = get_model(cfg, num_keypoints=KEYPOINTS)
    ckpt.load_flax_variables(fresh, back["params"], back["batch_stats"])
    fresh_opt = trainer.make_optimizer(cfg, SPE, fresh)[0]
    assert ckpt.load_optimizer_state_from_flax(fresh, fresh_opt, back["opt_state"]) == 3
    names = dict(model.named_parameters())
    for name, p in fresh.named_parameters():
        assert torch.equal(p, names[name]), name
        a, b = optimizer_.state[names[name]], fresh_opt.state[p]
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a[key], b[key]), (name, key)
        assert float(a["step"]) == float(b["step"]) == 3.0


def test_an_optimizer_state_of_another_optimizer_raises(tmp_path):
    from lightning_pose_tpu_torch.models.factory import get_model
    from lightning_pose_tpu_torch.train import checkpoints as ckpt
    from lightning_pose_tpu_torch.train import trainer

    cfg = _cfg("heatmap", "resnet18", "Adam")
    model = get_model(cfg, num_keypoints=KEYPOINTS)
    adam = trainer.make_optimizer(cfg, SPE, model)[0]
    tree = ckpt.optimizer_state_to_flax(model, adam)
    assert tree["inner_states"]["head"]["inner_state"]["0"]["count"] == 0
    cfg.training.optimizer = "AdamW"
    adamw = trainer.make_optimizer(cfg, SPE, model)[0]
    with pytest.raises(ValueError, match="Adam's"):
        ckpt.load_optimizer_state_from_flax(model, adamw, tree)
