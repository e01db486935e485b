"""Multi-GPU training and data-parallel prediction, on CPU ranks over gloo
(the JAX package tests its multi-device paths on virtual CPU devices).

- the process-group bring-up's environment variables, and the row split;
- in one spawn of two gloo ranks: cross-replica ``BatchNorm2d`` against
  flax's ``nn.BatchNorm`` on the concatenated batch, the step's gradient
  mechanism (outputs gathered, the loss times the world size, the gradient
  average) against one process in float64, the gradient bucket's handling
  of a missing gradient, and the broadcast of rank 0's weights;
- ``train(num_gpus=2, device="cpu")`` against ``num_gpus=1``;
- ``Model.from_dir(..., data_parallel=True)`` with two patched CPU replicas
  against the single-device route, as the JAX package's
  tests/api/test_data_parallel.py does.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

BN_SHAPE = (6, 5, 4, 3)  # (N, C, H, W), rows split 3 + 3
# flax's BatchNorm in fp32 against the port's cross-replica one in fp32:
# the variance as E[x^2] - E[x]^2 there, by Chan's merge here
BN_TOL = 1e-5
# the step's gradients on two ranks against one process, float64
GRAD_RTOL = 1e-10
# train(num_gpus=2) against num_gpus=1, fp32 on the CPU, two Adam steps at
# lr 1e-5 (as test_torch_semisup_train.py, whose notes on the fp32 gradient
# through the temperature-1000 decode hold here): the two runs sum the
# batch in another order (convolutions over 2 rows and 4, BatchNorm's
# merged statistics), so an entry whose gradient is near 0 can take the
# other sign at a step and move 2 lr apart. Most entries stay within lr/10
# and none moves more than a sign flip at each step apart.
TRAJ_LR = 1e-5
TRAJ_PARAM_TOL = TRAJ_LR / 10
TRAJ_PARAM_OFF_SHARE = 0.02
TRAJ_PARAM_MAX = 4 * TRAJ_LR
TRAJ_STATS_RTOL = 1e-4
TRAJ_LOSS_RTOL = 1e-4
# data-parallel prediction against one device, fp32 on the CPU: the same
# rows through convolutions of another batch size
DP_PX_TOL = 1e-3
DP_CONF_TOL = 1e-4


def test_initialize_distributed_reads_the_lp_tpu_variables(monkeypatch):
    """LP_TPU_COORDINATOR (host:port or a URL), LP_TPU_NUM_PROCESSES and
    LP_TPU_PROCESS_ID as in the JAX package; without them torchrun's
    ``env://``; explicit arguments win."""
    import torch.distributed as dist

    from lightning_pose_tpu_torch.parallel import mesh

    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(mesh, "sync_collectives", lambda: None)
    monkeypatch.setattr(mesh, "_one_host", True)
    monkeypatch.setenv("LP_TPU_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("LP_TPU_NUM_PROCESSES", "4")
    monkeypatch.setenv("LP_TPU_PROCESS_ID", "2")
    mesh.initialize_distributed(backend="gloo")
    assert calls[-1] == ("gloo", {"init_method": "tcp://10.0.0.1:1234", "world_size": 4, "rank": 2})
    assert mesh._one_host is False
    mesh.initialize_distributed("tcp://h:9", 2, 1, backend="nccl", one_host=True)
    assert calls[-1] == ("nccl", {"init_method": "tcp://h:9", "world_size": 2, "rank": 1})
    assert mesh._one_host is True
    monkeypatch.delenv("LP_TPU_PROCESS_ID")
    with pytest.raises(ValueError, match="LP_TPU_PROCESS_ID"):
        mesh.initialize_distributed(backend="gloo")
    for name in ("LP_TPU_COORDINATOR", "LP_TPU_NUM_PROCESSES"):
        monkeypatch.delenv(name)
    mesh.initialize_distributed(backend="gloo")
    assert calls[-1] == ("gloo", {"init_method": "env://"})
    # no group: one shard, rank 0 of 1
    assert (mesh.rank(), mesh.world_size(), mesh.stream_shard()) == (0, 1, (0, 1))


def test_rows_and_window_frames_split_as_the_jax_sharding():
    from lightning_pose_tpu_torch.parallel import mesh
    from lightning_pose_tpu_torch.train.trainer import _window_frames

    x = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(mesh.shard_rows(x, 1, 3), x[2:4])
    assert torch.equal(mesh.shard_rows(torch.arange(8), 1, 2), torch.arange(4, 8))
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard_rows(x, 0, 4)
    assert [_window_frames(8, False, r, 2) for r in range(2)] == [(0, 4), (4, 8)]
    # 12 frames: 8 context windows, 4 a rank, each with its 4 frames of halo
    assert [_window_frames(12, True, r, 2) for r in range(2)] == [(0, 8), (4, 12)]
    with pytest.raises(ValueError, match="context windows"):
        _window_frames(11, True, 0, 2)
    assert [str(d) for d in mesh.make_mesh()] in (["cpu"], [f"cuda:{i}" for i in range(torch.cuda.device_count())])
    with pytest.raises(ValueError, match="requested"):
        mesh.make_mesh(64)


# -- two gloo ranks, one spawn ---------------------------------------------------------


def _step_model() -> torch.nn.Module:
    from lightning_pose_tpu_torch.models.backbones.resnet import BatchNorm2d

    torch.manual_seed(0)
    return torch.nn.Sequential(
        torch.nn.Conv2d(3, 4, 3, padding=1), BatchNorm2d(4), torch.nn.ReLU(), torch.nn.Conv2d(4, 2, 3, padding=1)
    ).double()


def _step_loss(outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """A batch-mean loss whose weight depends on every row: a split by rows
    gives the single-process loss only through the gather."""
    err = (outputs - targets).square().mean(dim=(1, 2, 3))
    return (err * torch.softmax(err, dim=0)).sum()


def _ranks_worker(rank: int, world: int, port: int, inputs: dict, out_dir: str) -> None:
    """One of two gloo ranks: the checks that need a process group, each
    rank's results into ``out_dir``."""
    import torch.distributed as dist

    from lightning_pose_tpu_torch.models.backbones.resnet import BatchNorm2d
    from lightning_pose_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    mesh.initialize_distributed(f"tcp://127.0.0.1:{port}", world, rank, backend="gloo", one_host=True)
    out = {}
    # cross-replica BatchNorm, fp32
    bn = BatchNorm2d(BN_SHAPE[1], eps=1e-5, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inputs["bn_scale"]))
        bn.bias.copy_(torch.from_numpy(inputs["bn_bias"]))
    x = mesh.shard_rows(torch.from_numpy(inputs["bn_x"]), rank, world).requires_grad_()
    y = bn.train()(x)
    (y * mesh.shard_rows(torch.from_numpy(inputs["bn_dy"]), rank, world)).sum().backward()
    out.update(bn_y=y.detach().numpy(), bn_dx=x.grad.numpy(), bn_dscale=bn.weight.grad.numpy(),
               bn_dbias=bn.bias.grad.numpy(), bn_mean=bn.running_mean.numpy(), bn_var=bn.running_var.numpy())
    # the train step's gradient mechanism, float64
    model = _step_model()
    if rank == 1:  # a different init: replicate must give rank 0's
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    mesh.replicate(model)
    images = mesh.shard_rows(torch.from_numpy(inputs["images"]), rank, world)
    outputs = mesh.gather_rows(model(images))
    loss = _step_loss(outputs, torch.from_numpy(inputs["targets"]))
    (loss * world).backward()
    mesh.all_reduce_gradients(model.parameters())
    out["loss"] = loss.detach().numpy()
    for i, p in enumerate(model.parameters()):
        out[f"grad{i}"] = p.grad.numpy()
    out["running_var"] = model[1].running_var.numpy()
    # a gradient on rank 0 only enters as zeros on rank 1; none anywhere stays none
    a, b = torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(torch.zeros(2))
    if rank == 0:
        a.grad = torch.full((3,), 4.0)
    mesh.all_reduce_gradients([a, b])
    out["partial_grad"] = a.grad.numpy()
    out["no_grad"] = np.array(b.grad is None)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The inputs, and each rank's results, of one spawn of two gloo ranks."""
    import torch.multiprocessing as mp

    from lightning_pose_tpu_torch.train.trainer import _free_port

    rng = np.random.default_rng(0)
    inputs = {
        "bn_x": rng.normal(2.0, 3.0, BN_SHAPE).astype(np.float32),
        "bn_dy": rng.normal(size=BN_SHAPE).astype(np.float32),
        "bn_scale": rng.uniform(0.5, 1.5, BN_SHAPE[1]).astype(np.float32),
        "bn_bias": rng.normal(size=BN_SHAPE[1]).astype(np.float32),
        "images": rng.normal(size=(4, 3, 6, 6)),
        "targets": rng.normal(size=(4, 2, 6, 6)),
    }
    out_dir = tmp_path_factory.mktemp("ranks")
    mp.start_processes(_ranks_worker, args=(2, _free_port(), inputs, str(out_dir)), nprocs=2, join=True,
                       start_method="spawn")
    return inputs, [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(2)]


def test_cross_replica_batchnorm_matches_flax_on_the_concatenated_batch(two_ranks):
    """Output, input gradient, parameter gradients (summed over the ranks)
    and running statistics (flax's biased variance) as flax's BatchNorm on
    the whole batch."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    inputs, ranks = two_ranks
    x = jnp.asarray(inputs["bn_x"].transpose(0, 2, 3, 1))
    dy = jnp.asarray(inputs["bn_dy"].transpose(0, 2, 3, 1))
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), x)
    params = {"scale": jnp.asarray(inputs["bn_scale"]), "bias": jnp.asarray(inputs["bn_bias"])}

    def loss(params, x):
        y, updates = bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                              mutable=["batch_stats"])
        return (y * dy).sum(), (y, updates["batch_stats"])

    (_, (y, stats)), (dparams, dx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, x)

    def nchw(a):
        return np.asarray(a).transpose(0, 3, 1, 2)

    cat = {k: np.concatenate([r[k] for r in ranks]) for k in ("bn_y", "bn_dx")}
    np.testing.assert_allclose(cat["bn_y"], nchw(y), rtol=0, atol=BN_TOL)
    np.testing.assert_allclose(cat["bn_dx"], nchw(dx), rtol=0, atol=BN_TOL)
    np.testing.assert_allclose(ranks[0]["bn_dscale"] + ranks[1]["bn_dscale"], dparams["scale"], rtol=BN_TOL, atol=BN_TOL)
    np.testing.assert_allclose(ranks[0]["bn_dbias"] + ranks[1]["bn_dbias"], dparams["bias"], rtol=BN_TOL, atol=BN_TOL)
    for r in ranks:
        np.testing.assert_allclose(r["bn_mean"], stats["mean"], rtol=0, atol=BN_TOL)
        np.testing.assert_allclose(r["bn_var"], stats["var"], rtol=BN_TOL, atol=BN_TOL)


def test_two_ranks_take_the_single_process_gradient(two_ranks):
    """Float64: rows split over two ranks, outputs gathered, the loss times
    the world size, the gradients averaged, give one process's loss and
    gradients on the whole batch, and rank 0's init on both ranks."""
    inputs, ranks = two_ranks
    model = _step_model()
    loss = _step_loss(model.train()(torch.from_numpy(inputs["images"])), torch.from_numpy(inputs["targets"]))
    loss.backward()
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss.item(), rtol=GRAD_RTOL)
        for i, p in enumerate(model.parameters()):
            np.testing.assert_allclose(r[f"grad{i}"], p.grad.numpy(), rtol=GRAD_RTOL, atol=GRAD_RTOL)
        np.testing.assert_allclose(r["running_var"], model[1].running_var.detach().numpy(), rtol=GRAD_RTOL)
        np.testing.assert_array_equal(r["partial_grad"], np.full(3, 2.0))
        assert bool(r["no_grad"])


# -- train() on two CPU ranks ------------------------------------------------------


def _train_cfg(data: Path, semi: bool):
    """resnet18 at 128 px, 2 steps of 4; ``semi``: pca_singleview +
    temporal on an 8-frame window streamed as I420 (yuv420), the anneal
    weight 1 and the epsilons 0 so that the unsupervised term counts."""
    from lightning_pose_tpu_torch.config import load_config

    names = ["a", "b", "c", "d"]
    cfg = load_config()
    cfg.data.data_dir, cfg.data.video_dir = str(data), "videos"
    cfg.data.num_keypoints, cfg.data.keypoint_names = 4, names
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = 128
    cfg.model.backbone, cfg.model.model_name = "resnet18", "ranks"
    cfg.training.train_batch_size = cfg.training.val_batch_size = 4
    cfg.training.train_prob, cfg.training.val_prob = 0.7, 0.3
    cfg.training.max_epochs = cfg.training.min_epochs = cfg.training.unfreezing_epoch = None
    cfg.training.max_steps = cfg.training.min_steps = 2
    cfg.training.unfreezing_step = 0
    cfg.training.lr_scheduler_params.multisteplr.milestones = None
    cfg.training.lr_scheduler_params.multisteplr.milestone_steps = [1]
    cfg.training.optimizer_params.learning_rate = TRAJ_LR
    cfg.training.check_val_every_n_epoch = 1
    cfg.training.log_every_n_steps = 1
    cfg.dali.base.train.sequence_length = 8
    cfg.eval.predict_vids_after_training = False
    if semi:
        cfg.model.losses_to_use = ["pca_singleview", "temporal"]
        for name in ("pca_singleview", "temporal"):
            cfg.losses[name].log_weight = 0.0
            cfg.losses[name].epsilon = 0.0
        cfg.losses.temporal.prob_threshold = 0.0
        cfg.callbacks.anneal_weight.init_val = 1.0
        cfg.callbacks.anneal_weight.freeze_until_epoch = 0
        cfg.training.video_transfer_format = "yuv420"
    return cfg


@pytest.mark.parametrize("semi", [False, True], ids=["supervised", "pca_singleview+temporal"])
def test_train_on_two_cpu_ranks_matches_one(tmp_path, monkeypatch, semi):
    """``training.num_gpus: 2`` with ``device="cpu"``: two spawned gloo ranks
    take the steps one process takes on the same global batch (fp32, the
    compute dtype reaching the workers as an argument); rank 0 writes the
    model directory, and the returned model is its checkpoint. The
    semi-supervised runs stream their windows as I420 (a 2-step yuv420
    train(), each rank converting its frames) and log finite unsupervised
    losses."""
    from lightning_pose_tpu_torch.train import trainer
    from lightning_pose_tpu_torch.utils.synthetic import write_labeled_dataset, write_unlabeled_video

    monkeypatch.setattr(trainer, "COMPUTE_DTYPE", torch.float32)
    data = write_labeled_dataset(tmp_path / "data", 12, 128, 128, ["a", "b", "c", "d"], seed=1)
    write_unlabeled_video(data, "v0", 20, 128, 128, seed=2)
    results = {}
    for ranks in (1, 2):
        cfg = _train_cfg(data, semi)
        cfg.training.num_gpus = ranks
        results[ranks] = trainer.train(cfg, tmp_path / f"model{ranks}", skip_evaluation=True, device="cpu")
        assert cfg.data.keypoint_names == ["a", "b", "c", "d"]
    one, two = results[1], results[2]
    assert [h["step"] for h in one.history] == [h["step"] for h in two.history]
    if semi:
        # the first step's losses come from the same parameters; the second
        # one's temporal term (about 5e-5) moves with the first step's
        # rounding
        losses = [[h[k] for h in run.history if k in h] for run in (one, two)
                  for k in ("train_temporal_loss", "train_pca_singleview_loss")]
        assert all(len(x) == 2 and np.isfinite(x).all() for x in losses)
        for a, b in ((losses[0], losses[2]), (losses[1], losses[3])):
            assert np.isclose(a[0], b[0], rtol=TRAJ_LOSS_RTOL)
    val = [(a, b) for a, b in zip(one.history, two.history) if "val_supervised_loss" in a]
    assert val and all(np.isclose(a["val_supervised_loss"], b["val_supervised_loss"], rtol=TRAJ_LOSS_RTOL)
                       for a, b in val)
    assert sorted(p.name for p in (tmp_path / "model2").glob("tb_logs/ranks/version_*/checkpoints/*.ckpt")) == \
        sorted(p.name for p in (tmp_path / "model1").glob("tb_logs/ranks/version_*/checkpoints/*.ckpt"))
    assert (tmp_path / "model2" / "config.yaml").is_file()
    a, b = one.model.state_dict(), two.model.state_dict()
    diffs = np.concatenate([(a[k] - b[k]).abs().flatten().numpy() for k in a
                            if a[k].is_floating_point() and "running" not in k])
    assert diffs.max() <= TRAJ_PARAM_MAX
    assert (diffs > TRAJ_PARAM_TOL).mean() <= TRAJ_PARAM_OFF_SHARE
    for k in a:
        if "running" in k:
            np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), rtol=TRAJ_STATS_RTOL, atol=TRAJ_STATS_RTOL)


def test_a_failing_rank_makes_train_raise(tmp_path):
    """A rank that raises makes ``train()`` raise with its traceback: here
    every rank, on a labeled set that is not there."""
    import torch.multiprocessing as mp

    from lightning_pose_tpu_torch.train.trainer import train

    cfg = _train_cfg(tmp_path / "missing", semi=False)
    cfg.training.num_gpus = 2
    with pytest.raises(mp.ProcessRaisedException, match="Traceback"):
        train(cfg, tmp_path / "model", skip_evaluation=True, device="cpu")


# -- data-parallel prediction on two patched CPU replicas ---------------------------


@pytest.fixture()
def two_cpu_replicas(monkeypatch):
    from lightning_pose_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "devices", lambda num_devices=None: [torch.device("cpu")] * 2)


def _read(path: Path) -> pd.DataFrame:
    return pd.read_csv(path, header=[0, 1, 2], index_col=0)


def _assert_same(a: pd.DataFrame, b: pd.DataFrame) -> None:
    assert a.shape == b.shape
    xy = np.isin(a.columns.get_level_values("coords"), ["x", "y"])
    np.testing.assert_allclose(a.loc[:, xy].to_numpy(float), b.loc[:, xy].to_numpy(float), rtol=0, atol=DP_PX_TOL)
    np.testing.assert_allclose(a.loc[:, ~xy].select_dtypes("number").to_numpy(float),
                               b.loc[:, ~xy].select_dtypes("number").to_numpy(float), rtol=0, atol=DP_CONF_TOL)


@pytest.fixture(scope="module")
def context_model_dir(slice_model_dir, tmp_path_factory) -> Path:
    """The slice's config as a context model (``heatmap_mhcrnn``, 5-frame
    windows, batches of 9 frames), with seeded weights and a peaked head."""
    from conftest import HEAD_SCALE

    from lightning_pose_tpu_torch.config import Config
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.train import checkpoints as ckpt_utils

    cfg = Config.from_yaml(str(slice_model_dir / "config.yaml"))
    cfg.model.model_type = "heatmap_mhcrnn"
    cfg.model.model_name = "context"
    cfg.dali.context.predict.sequence_length = 9
    torch.manual_seed(3)
    model = build_model("heatmap_mhcrnn", "resnet18", 4)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "deconv" in name and name.endswith("weight"):
                p.mul_(HEAD_SCALE)
    model_dir = tmp_path_factory.mktemp("context") / "model"
    version_dir = ckpt_utils.next_version_dir(str(model_dir), "context")
    ckpt_utils.save_module(str(Path(ckpt_utils.checkpoint_dir(version_dir)) / "epoch=1-step=10-best.ckpt"),
                           model, 10, 1)
    cfg.save(str(model_dir / "config.yaml"))
    return model_dir


@pytest.mark.parametrize("kind", ["heatmap", "context"])
def test_data_parallel_video_matches_one_device(slice_model_dir, context_model_dir, slice_video, tmp_path,
                                                two_cpu_replicas, kind):
    """A video split over two replicas, padded to a multiple of 2 and
    trimmed; a context model's windows each take a shard with 4 frames of
    halo: the single-device CSV."""
    from lightning_pose_tpu_torch.api.model import DataParallelPredict, Model

    model_dir = slice_model_dir if kind == "heatmap" else context_model_dir
    serial = Model.from_dir(model_dir, precision="fp32", device="cpu")
    serial.predict_on_video_file(slice_video, compute_metrics=False, output_dir=tmp_path / "s")
    sharded = Model.from_dir(model_dir, precision="fp32", device="cpu", data_parallel=True)
    sharded.predict_on_video_file(slice_video, compute_metrics=False, output_dir=tmp_path / "p")
    assert isinstance(sharded._predict_fn, DataParallelPredict) and len(sharded._predict_fn.steps) == 2
    assert sharded._predict_fn.steps[0] is sharded._predict_step
    a, b = _read(tmp_path / "s" / "blobs.csv"), _read(tmp_path / "p" / "blobs.csv")
    assert len(a) == len(b) == 20
    _assert_same(a, b)


def test_data_parallel_predict_frame_pads_to_the_replicas(slice_model_dir, context_model_dir, two_cpu_replicas):
    """One frame (one context stack) padded to two rows and trimmed."""
    from lightning_pose_tpu_torch.api.model import Model

    rng = np.random.default_rng(3)
    for model_dir, frame in ((slice_model_dir, rng.integers(0, 255, (60, 80, 3), dtype=np.uint8)),
                             (context_model_dir, rng.integers(0, 255, (5, 60, 80, 3), dtype=np.uint8))):
        serial = Model.from_dir(model_dir, precision="fp32", device="cpu").predict_frame(frame)
        sharded = Model.from_dir(model_dir, precision="fp32", device="cpu", data_parallel=True).predict_frame(frame)
        np.testing.assert_allclose(sharded["keypoints"], serial["keypoints"], rtol=0, atol=DP_PX_TOL)
        np.testing.assert_allclose(sharded["confidence"], serial["confidence"], rtol=0, atol=DP_CONF_TOL)


def test_data_parallel_label_csv_matches_one_device(slice_model_dir, tmp_path, two_cpu_replicas):
    """Labeled frames in batches the replicas do not divide (7 frames; the
    slice's weights at 128 px, the labeled dataset's least size)."""
    import shutil

    from lightning_pose_tpu_torch.api.model import Model
    from lightning_pose_tpu_torch.config import Config
    from lightning_pose_tpu_torch.utils.synthetic import write_labeled_dataset

    model_dir = Path(shutil.copytree(slice_model_dir, tmp_path / "m"))
    cfg = Config.from_yaml(str(model_dir / "config.yaml"))
    cfg.apply_overrides(["data.image_resize_dims.height=128", "data.image_resize_dims.width=128"])
    cfg.save(str(model_dir / "config.yaml"))
    data = write_labeled_dataset(tmp_path / "data", 7, 120, 160, [f"kp{i}" for i in range(4)], seed=4)
    kwargs = dict(data_dir=data, compute_metrics=False)
    serial = Model.from_dir(model_dir, precision="fp32", device="cpu").predict_on_label_csv(
        "CollectedData.csv", output_dir=tmp_path / "s", **kwargs)
    sharded = Model.from_dir(model_dir, precision="fp32", device="cpu", data_parallel=True).predict_on_label_csv(
        "CollectedData.csv", output_dir=tmp_path / "p", **kwargs)
    assert len(serial.predictions) == 7
    _assert_same(serial.predictions, sharded.predictions)


def test_data_parallel_export_is_the_single_device_step(slice_model_dir, tmp_path, two_cpu_replicas):
    """``export()`` under data_parallel exports the single-device step; the
    program agrees with the split route. Its runtime transfers rgb whatever
    ``eval.video_transfer_format`` says (its input shapes are RGB), as in
    the JAX package."""
    from lightning_pose_tpu_torch.api.model import Model

    model = Model.from_dir(slice_model_dir, precision="fp32", device="cpu", data_parallel=True)
    path = model.export(tmp_path / "export")
    program = Model.load_exported(path)
    images = torch.from_numpy(np.random.default_rng(0).integers(0, 255, (8, 64, 64, 3), dtype=np.uint8))
    bbox = torch.tensor([[0.0, 0.0, 64.0, 64.0]] * 8)
    kp, conf = program(images, bbox)
    kp_dp, conf_dp = model._predict_fn(images, bbox)
    np.testing.assert_allclose(kp.detach().numpy(), kp_dp.numpy(), rtol=0, atol=DP_PX_TOL)
    np.testing.assert_allclose(conf.detach().numpy(), conf_dp.numpy(), rtol=0, atol=DP_CONF_TOL)
    model.cfg.eval.video_transfer_format = "yuv420"
    assert model._video_transfer_format() == "yuv420"
    model.use_exported_runtime(path)
    assert model._video_transfer_format() == "rgb"


def test_data_parallel_with_one_device_predicts_as_without(slice_model_dir, caplog):
    """One visible device: logged, and the plain step (JAX
    api/model.py:324-326)."""
    import logging

    from lightning_pose_tpu_torch.api.model import Model, PredictStep

    with caplog.at_level(logging.INFO):
        model = Model.from_dir(slice_model_dir, device="cpu", data_parallel=True)
        model._load()
    assert isinstance(model._predict_fn, PredictStep)
    assert "only one device" in caplog.text
