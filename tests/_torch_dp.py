"""Data-parallel workers for the port's CPU tests.

`run_ranks(tmp_path, task, job)` runs `task` in W processes of this file,
joined in a gloo group through a `file://` rendezvous in `tmp_path` (no
port to collide between test workers), each with one torch thread and
`job` (a dict saved with torch.save), and returns each rank's result.
Every wait is bounded: the group's collectives time out after 60 s and the
processes are killed after `timeout` s. The workers import only torch,
numpy and `icl_tpu_torch`; the tests compute the JAX side themselves.
"""
import datetime
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT = datetime.timedelta(seconds=60)


def run_ranks(tmp_path, task: str, job: dict, world: int = 2, timeout: float = 240.0,
              script: str = __file__) -> list:
    """`task` of the TASKS of `script` (this file, or another helper whose
    `main` is `serve(TASKS)`) in `world` processes; each rank's result."""
    job_path = tmp_path / f"{task}_job.pt"
    torch.save(job, job_path)
    outs = [tmp_path / f"{task}_rank{r}.pt" for r in range(world)]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, os.path.abspath(script), task, str(world), str(tmp_path / f"{task}_init"),
           str(job_path)]
    procs = [subprocess.Popen(cmd + [str(r), str(outs[r])], cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {task} exited {p.returncode}:\n{out[-2000:]}\n{err[-4000:]}"
    return [torch.load(o, weights_only=False) for o in outs]


def _rows(batch: dict, labeled_bs: int, rank: int, world: int) -> dict:
    from icl_tpu_torch.parallel.multihost import host_slice

    return host_slice(batch, labeled_bs, rank, world)


def task_steps(job: dict, rank: int, world: int) -> dict:
    """One ICL step per case on this rank's rows (f64, zero_stochastic):
    metrics, reduced gradients, new state; then `bf16_steps` steps of a
    bf16-state Trainer: its parameters and momentum."""
    from icl_tpu_torch.config import ExperimentConfig
    from icl_tpu_torch.models.registry import net_factory
    from icl_tpu_torch.train.optim import PolySGD
    from icl_tpu_torch.train.steps import make_icl_step
    from icl_tpu_torch.train.trainer import Trainer

    out = {}
    for name, case in job["cases"].items():
        model = net_factory(case["model"], 1, case["classes"], device="cpu",
                            patch_size=case["patch"], fuse_sspa_pair=case["fuse"],
                            zero_stochastic=True)
        model.load_state_dict(case["old"], strict=True)
        model = model.double().train()
        opt = PolySGD(model.parameters(), case["lr"], case["max_it"])
        step = make_icl_step(model, opt, case["classes"], case["labeled_bs"] // world,
                             (case["patch"],) * case["dims"], case["consis"])
        metrics = step(_rows(case["batch"], case["labeled_bs"], rank, world))
        out[name] = {"metrics": {k: float(v) for k, v in metrics.items()},
                     "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
                     "state": {k: v.clone() for k, v in model.state_dict().items()},
                     "momentum": [b.clone() for b in opt.momentum_buffers]}
    bf16 = job["bf16"]
    cfg = ExperimentConfig(**bf16["cfg"])
    trainer = Trainer(cfg, device="cpu")
    for batch in bf16["batches"]:
        trainer.train_step(trainer.to_device(_rows(batch, cfg.labeled_bs, rank, world)))
    out["bf16"] = {"state": trainer.model.state_dict(), "momentum": trainer.optimizer.momentum_buffers}
    return out


def task_reductions(job: dict, rank: int, world: int) -> dict:
    """The reductions alone on this rank's rows of the job's tensors: the
    global BatchNorm (output, running stats, and the input's and affine
    gradients of a loss that passes it and then the Dice and CE sums), the
    global labeled-query mean, and the global Dice, CE and MSE terms."""
    from icl_tpu_torch import losses
    from icl_tpu_torch.models.layers import batch_norm
    from icl_tpu_torch.parallel.collectives import global_mean, reduce_gradients

    n = job["x"].shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    x = job["x"][rows].clone().requires_grad_(True)
    bn = batch_norm(x.shape[1], 2).double()
    with torch.no_grad():
        bn.weight.copy_(job["weight"])
        bn.bias.copy_(job["bias"])
    y = bn(x)
    labels = job["labels"][rows]
    loss = (losses.multiclass_dice_loss(y, labels, x.shape[1], softmax=True)
            + losses.cross_entropy_loss(y, labels))
    loss.backward()
    x_grad = x.grad.clone()
    reduce_gradients(list(bn.parameters()))
    q = job["q"][rows]
    a, b = job["maps"][0][rows], job["maps"][1][rows]
    return {"y": y.detach(), "loss": loss.detach(), "x_grad": x_grad,
            "weight_grad": bn.weight.grad, "bias_grad": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var,
            "query_mean": global_mean(q, 0, keepdim=True),
            "dice": losses.multiclass_dice_loss(a, labels, a.shape[1], softmax=True),
            "soft_dice": losses.softmax_dice_loss(a, b), "ce": losses.cross_entropy_loss(a, labels),
            "mse": losses.softmax_mse_loss([a], [b])}


def task_multihost(job: dict, rank: int, world: int) -> dict:
    """`all_gather_case_metrics` of per-rank lists; the sliding window over
    the group; `Trainer.fit` over the group in a directory of this rank's
    own (scan_steps 2); every rank's `restore_state` of rank 0's save; the
    device augment's refusal."""
    import torch.distributed as dist

    from icl_tpu_torch.config import ExperimentConfig
    from icl_tpu_torch.eval.infer3d import make_fused_sliding_window
    from icl_tpu_torch.models.registry import net_factory
    from icl_tpu_torch.parallel.multihost import all_gather_case_metrics, host_local_batches
    from icl_tpu_torch.train.trainer import Trainer, acdc_evaluator

    out = {}
    local = [[(float(rank), 10.0 + rank), (float(rank) + 0.25, 20.0 + rank)],
             [(float(rank) + 0.5, 30.0 + rank), (float(rank) + 0.75, 40.0 + rank)]]
    out["gathered"] = [[[float(v) for v in row] for row in cls] for cls in all_gather_case_metrics(local)]

    sw = job["sliding_window"]
    model = net_factory("swinunetr", 1, 2, device="cpu", feature_size=sw["feature_size"],
                        generator=torch.Generator().manual_seed(0)).eval()
    predict = make_fused_sliding_window(model, 2, sw["patch"], sw_batch=sw["sw_batch"], device="cpu",
                                        group=dist.group.WORLD)
    out["label_map"] = predict(sw["volume"], sw["stride"], sw["stride"])

    fit = job["fit"]
    cfg = ExperimentConfig(**fit["cfg"], experiments_dir=os.path.join(fit["dir"], f"rank{rank}",
                                                                      "experiments"))
    trainer = Trainer(cfg, device="cpu")
    batches = host_local_batches(iter(fit["batches"]), cfg.labeled_bs, rank, world)
    result = trainer.fit(batches, evaluate=acdc_evaluator(fit["volumes"], cfg.num_classes,
                                                          cfg.patch_size, "cpu"))
    out["fit"] = {"log": result["log"], "vals": result["vals"], "best_path": result["best_path"],
                  "saves": [s["path"] for s in result["saves"]],
                  "state": {k: v.clone() for k, v in trainer.model.state_dict().items()}}
    rank0_dir = os.path.join(fit["dir"], "rank0", "experiments")
    resumed = Trainer(ExperimentConfig(**fit["cfg"], experiments_dir=rank0_dir), device="cpu")
    out["resume"] = {"iteration": resumed.restore_state(), "state": resumed.model.state_dict(),
                     "rng": torch.get_rng_state()}
    try:
        Trainer(ExperimentConfig(**fit["cfg"], device_augment=True), device="cpu")
    except ValueError as e:
        out["device_augment_refused"] = str(e)
    return out


def task_accum(job: dict, rank: int, world: int) -> dict:
    """`job["steps"]` micro-steps of the ICL step with gradient accumulation
    (`job["grad_accum"]`, f64, zero_stochastic) on this rank's rows of each
    global batch: the parameters, momentum and accumulators after each
    step."""
    from icl_tpu_torch.models.registry import net_factory
    from icl_tpu_torch.train.optim import PolySGD
    from icl_tpu_torch.train.steps import make_icl_step

    model = net_factory("icl_unet", 1, job["classes"], device="cpu", patch_size=job["patch"],
                        zero_stochastic=True)
    model.load_state_dict(job["old"], strict=True)
    model = model.double().train()
    opt = PolySGD(model.parameters(), job["lr"], job["max_it"], grad_accum=job["grad_accum"])
    step = make_icl_step(model, opt, job["classes"], job["labeled_bs"] // world,
                         (job["patch"],) * 2, job["consis"])
    states = []
    for batch in job["batches"]:
        step(_rows(batch, job["labeled_bs"], rank, world))
        states.append({"params": {n: p.detach().clone() for n, p in model.named_parameters()},
                       "momentum": [b.clone() for b in opt.momentum_buffers],
                       "accumulators": [a.clone() for a in opt.accumulators]})
    return {"states": states, "count": opt.count, "micro": opt.micro}


TASKS = {"steps": task_steps, "reductions": task_reductions, "multihost": task_multihost,
         "accum": task_accum}


def serve(tasks: dict) -> None:
    """A worker's main: join the gloo group of the command line, run its
    task of `tasks` and save the result."""
    import torch.distributed as dist

    task, world, init, job_path, rank, out = sys.argv[1:]
    world, rank = int(world), int(rank)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", world_size=world, rank=rank,
                            timeout=GROUP_TIMEOUT)
    try:
        result = tasks[task](torch.load(job_path, weights_only=False), rank, world)
        torch.save(result, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    serve(TASKS)


def assert_takes_multi_process_flags(cli, argv=("--root_path", "unused")) -> None:
    """An ICL training CLI takes the JAX CLIs' three multi-process flags with
    their defaults, refuses a process count that does not split both
    branches of its batch before it connects, and still needs the card
    without `--device cpu` (checked with CUDA made absent by the caller)."""
    import pytest

    args = cli.parse_args([])
    assert (args.dist_coordinator, args.num_processes, args.process_id) == (None, None, None)
    flags = ["--dist_coordinator", "host0:1234", "--num_processes", "2", "--process_id", "1"]
    args = cli.parse_args(flags)
    assert (args.dist_coordinator, args.num_processes, args.process_id) == ("host0:1234", 2, 1)
    with pytest.raises(ValueError, match="divisible"):
        cli.main(list(argv) + ["--dist_coordinator", "127.0.0.1:1", "--num_processes", "3",
                               "--process_id", "0"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(list(argv) + ["--dist_coordinator", "127.0.0.1:1", "--num_processes", "2",
                               "--process_id", "0"])
