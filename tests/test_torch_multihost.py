"""icl_tpu_torch's multi-process launch on the CPU: the row layout of
`parallel.multihost` (each rank's share of each branch; the concatenation
over the ranks, per branch, is the global batch), `initialize_from_args`'s
env fallbacks and checks, and over two gloo processes:
`all_gather_case_metrics` against the JAX package's two-process result
(`tests/test_two_process.py`), `make_fused_sliding_window(group=...)`
against the one-process label map, `Trainer.fit` (rank 0 alone writes,
`scan_steps` 2 falls back to single steps, every rank resumes from rank
0's state and seeds its generators anew, the device augment is refused),
and the flagship CLI as two processes through `--dist_coordinator`, whose
stripped best checkpoint gives the validation dice through the eval CLI.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from icl_tpu.data.synth import make_synthetic_acdc

from icl_tpu_torch.data.pipeline import acdc_train_batches
from icl_tpu_torch.data.synth import synthetic_acdc
from icl_tpu_torch.eval.infer3d import make_fused_sliding_window
from icl_tpu_torch.models.registry import net_factory
from icl_tpu_torch.parallel import multihost
from icl_tpu_torch.parallel.mesh import create_mesh
from _torch_dp import ROOT, run_ranks
from _torch_threads import one_torch_thread  # noqa: F401  (a fixture)

# tests/test_two_process.py:57-60
EXPECTED_GATHER = [
    [[0.0, 10.0], [0.25, 20.0], [1.0, 11.0], [1.25, 21.0]],
    [[0.5, 30.0], [0.75, 40.0], [1.5, 31.0], [1.75, 41.0]],
]
PATCH, BATCH, LABELED = 32, 4, 2


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("batch_size,labeled_bs,world", [(4, 2, 2), (16, 8, 2), (16, 8, 4), (6, 2, 2)])
def test_rank_rows_reassemble_the_global_batch_per_branch(batch_size, labeled_bs, world):
    rows = [multihost.host_rows(batch_size, labeled_bs, r, world) for r in range(world)]
    lab, unl = labeled_bs // world, (batch_size - labeled_bs) // world
    assert all(len(r) == lab + unl for r in rows)
    assert np.concatenate([r[:lab] for r in rows]).tolist() == list(range(labeled_bs))
    assert np.concatenate([r[lab:] for r in rows]).tolist() == list(range(labeled_bs, batch_size))
    batch = {"image": np.arange(batch_size * 3).reshape(batch_size, 3), "label": np.arange(batch_size)}
    parts = [multihost.host_slice(batch, labeled_bs, r, world) for r in range(world)]
    assert [p["label"].tolist() for p in parts] == [batch["label"][r].tolist() for r in rows]


def test_rows_that_do_not_split_raise_and_batches_are_deterministic():
    for batch_size, labeled_bs, world in ((16, 8, 3), (5, 2, 2), (6, 3, 2)):
        with pytest.raises(ValueError, match="divisible"):
            multihost.host_rows(batch_size, labeled_bs, 0, world)
    slices, _ = synthetic_acdc(12, 0, 40, 1, 4, seed=1)

    def rank_batches(rank):
        stream = acdc_train_batches(slices, 5, BATCH, LABELED, (PATCH, PATCH), seed=3)
        return list(zip(range(3), multihost.host_local_batches(stream, LABELED, rank, 2)))

    first, again, other = rank_batches(0), rank_batches(0), rank_batches(1)
    for (_, a), (_, b), (_, c) in zip(first, again, other):
        np.testing.assert_array_equal(a["image"], b["image"])
        assert a["image"].shape == (2, 1, PATCH, PATCH) and not np.array_equal(a["image"], c["image"])
    whole = list(zip(range(3), acdc_train_batches(slices, 5, BATCH, LABELED, (PATCH, PATCH), seed=3)))
    for (_, w), (_, a), (_, c) in zip(whole, first, other):
        np.testing.assert_array_equal(w["label"], np.stack([a["label"][0], c["label"][0],
                                                            a["label"][1], c["label"][1]]))


def test_initialize_takes_env_fallbacks_and_one_process_is_a_no_op(monkeypatch):
    for k in ("ICL_TPU_COORDINATOR", "ICL_TPU_NUM_PROCESSES", "ICL_TPU_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize_from_args(device="cpu") == (0, 1)
    assert multihost.initialize_from_args(num_processes=1, process_id=0, device="cpu",
                                          rows=(16, 8)) == (0, 1)
    assert not torch.distributed.is_initialized()
    mesh = create_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device) == (None, 0, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="model=2 does not divide the 1 processes"):
        create_mesh(model=2, device="cpu")
    monkeypatch.setenv("ICL_TPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("ICL_TPU_PROCESS_ID", "1")
    with pytest.raises(ValueError, match="dist_coordinator"):  # read from the env, checked first
        multihost.initialize_from_args(device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        multihost.initialize_from_args(device="cpu", rows=(16, 7))
    monkeypatch.setenv("ICL_TPU_PROCESS_ID", "2")
    with pytest.raises(ValueError, match="process_id 2 of 2"):
        multihost.initialize_from_args(device="cpu")
    monkeypatch.setenv("ICL_TPU_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):  # the card, before any connection
        multihost.initialize_from_args(process_id=0)
    assert not torch.distributed.is_initialized()
    assert multihost.all_gather_case_metrics(EXPECTED_GATHER) is EXPECTED_GATHER


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    slices, volumes = synthetic_acdc(12, 2, 40, 2, 4, seed=2)
    fit_cfg = dict(model="icl_unet", num_classes=4, batch_size=BATCH, labeled_bs=LABELED,
                   patch_size=(PATCH, PATCH), max_iterations=2, val_interval=2, seed=3,
                   scan_steps=2, exp="ACDC/ICL", labeled_num=3, num_tries="dp")
    batches = list(zip(range(2), acdc_train_batches(slices, 5, BATCH, LABELED, (PATCH, PATCH), seed=3)))
    volume = np.random.default_rng(0).standard_normal((48, 40, 36)).astype(np.float32)
    job = {"sliding_window": {"feature_size": 12, "patch": (PATCH,) * 3, "sw_batch": 2,
                              "stride": 16, "volume": volume},
           "fit": {"cfg": fit_cfg, "dir": str(tmp), "batches": [b for _, b in batches],
                   "volumes": volumes}}
    return job, run_ranks(tmp, "multihost", job)


def test_case_metrics_gather_as_the_jax_package(two_ranks):
    _, ranks = two_ranks
    for r in ranks:
        assert r["gathered"] == EXPECTED_GATHER


def test_sliding_window_over_two_ranks_equals_one_process(two_ranks):
    job, ranks = two_ranks
    sw = job["sliding_window"]
    model = net_factory("swinunetr", 1, 2, device="cpu", feature_size=sw["feature_size"],
                        generator=torch.Generator().manual_seed(0)).eval()
    want = make_fused_sliding_window(model, 2, sw["patch"], sw_batch=sw["sw_batch"], device="cpu")(
        sw["volume"], sw["stride"], sw["stride"])
    assert len(np.unique(want)) == 2  # both classes present: the map is not trivial
    for r in ranks:
        np.testing.assert_array_equal(r["label_map"], want)


def test_fit_over_two_ranks_writes_from_rank_0_only(two_ranks):
    job, (r0, r1) = two_ranks
    root = job["fit"]["dir"]
    assert not os.path.exists(os.path.join(root, "rank1"))
    snapshot = os.path.join(root, "rank0", "experiments", "ACDC", "ICL_3_labeled", "icl_unet_exp_dp")
    assert sorted(os.listdir(os.path.join(snapshot, "model"))) == ["model_best.pth", "state_last.pt"]
    with open(os.path.join(snapshot, "log.txt")) as f:
        text = f.read()
    assert "scan_steps>1 unsupported under multi-process; falling back to per-step dispatch" in text
    assert text.count("iteration 1 : loss") == text.count("iteration 2 : loss") == 1
    assert [len(r["fit"]["vals"]) for r in (r0, r1)] == [1, 0] and r1["fit"]["best_path"] is None
    assert r1["fit"]["saves"] == [] and len(r0["fit"]["saves"]) == 1
    assert [row["loss"] for row in r0["fit"]["log"]] == [row["loss"] for row in r1["fit"]["log"]]
    for k, v in r0["fit"]["state"].items():
        assert torch.equal(v, r1["fit"]["state"][k]), k
    for r in (r0, r1):
        assert "use --input_mode host" in r["device_augment_refused"]


def test_every_rank_resumes_from_rank_0s_state_with_generators_of_its_own(two_ranks):
    _, (r0, r1) = two_ranks
    for r in (r0, r1):
        assert r["resume"]["iteration"] == 2
        for k, v in r0["fit"]["state"].items():
            assert torch.equal(r["resume"]["state"][k], v), k
    assert not torch.equal(r0["resume"]["rng"], r1["resume"]["rng"])


def test_flagship_cli_as_two_processes_and_eval_cli_reproduces_val_dice(tmp_path, monkeypatch):
    """Two steps of U-Net-ICL at 32^2, batch 4 (2 labeled), validation at
    step 2, as two CPU processes joined through --dist_coordinator; only
    rank 0 prints and writes; the eval CLI on its stripped best checkpoint
    gives its validation dice, exactly."""
    pytest.importorskip("h5py")
    from icl_tpu_torch.scripts import test_2D_ACDC

    root = tmp_path / "ACDC"
    make_synthetic_acdc(str(root), num_slices=72, num_volumes=2, slice_size=40, vol_depth=3, seed=0)
    common = ["--root_path", str(root), "--exp", "ACDC/ICL", "--labeled_num", "3",
              "--num_tries", "t", "--patch_size", str(PATCH), str(PATCH), "--device", "cpu"]
    train = common + ["--max_iterations", "2", "--val_interval", "2", "--batch_size", str(BATCH),
                      "--labeled_bs", str(LABELED), "--num_processes", "2",
                      "--dist_coordinator", f"127.0.0.1:{_free_port()}"]
    cwd = [tmp_path / f"rank{r}" / "cwd" for r in range(2)]  # snapshots: ../experiments of each
    for d in cwd:
        d.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "icl_tpu_torch.scripts."
                               "train_inherent_consistent_unet_2D"] + train + ["--process_id", str(r)],
                              cwd=cwd[r], env=env, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-2000:]}\n{err[-4000:]}"
    assert "Training Finished!" in logs[0][0] and "Total slices" in logs[0][0]
    assert "backend gloo" in logs[0][0]
    assert logs[1][0].strip() == ""
    assert os.listdir(tmp_path / "rank1") == ["cwd"] and not os.listdir(cwd[1])
    snapshot = tmp_path / "rank0" / "experiments" / "ACDC" / "ICL_3_labeled" / "icl_unet_exp_t"
    rows = [json.loads(line) for line in open(snapshot / "log" / "scalars.jsonl")]
    val = [r["value"] for r in rows if r["tag"] == "metric_all/mean_dice"]
    assert len(val) == 1
    monkeypatch.chdir(cwd[0])
    assert test_2D_ACDC.main(common)[0] == val[0]
