"""Tensor-parallel workers for the port's CPU tests (`run_ranks(...,
script=_torch_tp.__file__)` of `_torch_dp.py`): gloo groups through a
`file://` rendezvous, one torch thread a rank, every wait bounded. The
workers import only torch, numpy and `icl_tpu_torch`; the tests compute
the JAX side themselves.
"""
import copy

import torch
from torch import nn

from _torch_dp import serve


class Encoder10(nn.Module):
    """SwinUNETR's widest residual block under its key, `encoder10.layer`."""

    def __init__(self, channels: int):
        super().__init__()
        from icl_tpu_torch.models.swinunetr import UnetrBasicBlock

        self.encoder10 = UnetrBasicBlock(channels, channels)

    def forward(self, x):
        return self.encoder10(x)


def module_case(kind: str):
    """(the whole module, f64, from seed 0; a function of the case's
    inputs to its outputs) for each module test case."""
    from icl_tpu_torch.models.icl import ClassDecoder
    from icl_tpu_torch.models.layers import build_model
    from icl_tpu_torch.models.swin2d import SwinBlock
    from icl_tpu_torch.models.swinunetr import SwinBlock3D

    gen = torch.Generator().manual_seed(0)
    if kind.startswith("class_decoder"):
        dim, n_patch, heads = {"class_decoder_2d": (32, 16, 4), "class_decoder_3d": (48, 64, 6)}[kind]
        m = build_model(ClassDecoder, dim, n_patch, heads, device="cpu", generator=gen)
        return m.double(), lambda m, q, x: m(q, x)
    if kind.startswith("swin2d"):
        dim, heads, shift = {"swin2d_none": (32, 4, 0), "swin2d_mask": (32, 4, 2),
                             "swin2d_three_heads": (24, 3, 2)}[kind]
        m = build_model(SwinBlock, dim, (8, 8), heads, 4, shift, device="cpu", generator=gen)
        return m.double(), lambda m, x: (m(x),)
    if kind == "swin3d_region":
        from icl_tpu_torch.models.swinunetr import window_region_ids_3d

        m = build_model(SwinBlock3D, 24, 2, (4, 4, 4), device="cpu", generator=gen)
        ids = torch.from_numpy(window_region_ids_3d((8, 8, 8), (4, 4, 4), (2, 2, 2)))
        return m.double(), lambda m, x: (m(x, (4, 4, 4), (2, 2, 2), ids),)
    m = build_model(Encoder10, 16, device="cpu", generator=gen)
    return m.double(), lambda m, x: (m(x),)


def _run(module, fn, inputs, grads):
    xs = [x.clone().requires_grad_(True) for x in inputs]
    outs = fn(module, *xs)
    sum(float(0) + (o * g).sum() for o, g in zip(outs, grads)).backward()
    return [o.detach() for o in outs], [x.grad for x in xs]


def task_modules(job: dict, rank: int, world: int) -> dict:
    """Each case's module whole and sharded over the `world` ranks (f64):
    the largest differences of the outputs, the input gradients and every
    parameter gradient (a shard's against its slice of the whole one),
    the keys sharded and the layers left replicated."""
    from icl_tpu_torch.parallel.mesh import create_mesh, replicated_layers, shard_model
    from icl_tpu_torch.parallel.tensor import param_splits

    mesh = create_mesh(data=1, model=world, device="cpu")
    out = {}
    for kind, case in job.items():
        whole, fn = module_case(kind)
        part = shard_model(copy.deepcopy(whole), mesh)
        outs_w, in_grads_w = _run(whole, fn, case["inputs"], case["grads"])
        outs_p, in_grads_p = _run(part, fn, case["inputs"], case["grads"])
        splits = param_splits(part)
        whole_grads = {n: p.grad for n, p in whole.named_parameters()}
        param_errs = {}
        for n, p in part.named_parameters():
            want = whole_grads[n] if n not in splits else splits[n].take(whole_grads[n])
            assert p.grad is not None, n
            param_errs[n] = float((p.grad - want).abs().max())
        out[kind] = {
            "out_err": max(float((a - b).abs().max()) for a, b in zip(outs_w, outs_p)),
            "in_grad_err": max(float((a - b).abs().max()) for a, b in zip(in_grads_w, in_grads_p)),
            "param_errs": param_errs, "sharded": sorted(splits),
            "replicated": replicated_layers(whole, world),
            "scale": max(float(o.abs().max()) for o in outs_w)}
    return out


def _sharded_step(model, opt_kw: dict, case: dict, mesh):
    """One ICL step of `model` sharded over `mesh` on this data rank's rows
    of the case's global batch: (metrics, the gathered state dict, the
    gathered momentum buffers by parameter name)."""
    from icl_tpu_torch.parallel.multihost import host_slice
    from icl_tpu_torch.parallel.tensor import param_splits
    from icl_tpu_torch.train.optim import PolySGD
    from icl_tpu_torch.train.steps import make_icl_step
    from icl_tpu_torch.utils.checkpoint import gather_train_state

    splits = param_splits(model)
    opt = PolySGD(model.parameters(), case["lr"], case["max_it"],
                  shards=[splits.get(n) for n, _ in model.named_parameters()], **opt_kw)
    step = make_icl_step(model, opt, case["classes"], case["labeled_bs"] // mesh.size,
                         (case["patch"],) * case["dims"], case["consis"])
    metrics = step(host_slice(case["batch"], case["labeled_bs"], mesh.rank, mesh.size))
    state = gather_train_state({"model": model.state_dict(), "optimizer": opt.state_dict()}, model,
                               opt)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    momentum = {names[i]: v["momentum_buffer"] for i, v in state["optimizer"]["state"].items()}
    return {k: float(v) for k, v in metrics.items()}, state["model"], momentum


def task_steps(job: dict, rank: int, world: int) -> dict:
    """Over a (world // model, model) mesh: one f64 ICL step a case
    (`zero_stochastic`, from the case's state), gathered; then
    `job["replicas"]`: `steps` Trainer steps with dropout and drop path on,
    this rank's replicated leaves; the mesh's refusals; and the sliding
    window of a sharded SwinUNETR over the data group."""
    from icl_tpu_torch.config import ExperimentConfig
    from icl_tpu_torch.eval.infer3d import make_fused_sliding_window
    from icl_tpu_torch.models.layers import build_model
    from icl_tpu_torch.models.registry import net_factory
    from icl_tpu_torch.models.swinunetr_icl import SwinUNETRICL
    from icl_tpu_torch.parallel.mesh import create_mesh, shard_model
    from icl_tpu_torch.parallel.multihost import host_slice
    from icl_tpu_torch.parallel.tensor import param_splits
    from icl_tpu_torch.train.trainer import Trainer

    mesh = create_mesh(data=world // job["model"], model=job["model"], device="cpu")
    out = {"mesh": (mesh.rank, mesh.size, mesh.model_rank, mesh.model_size)}
    for name, case in job["cases"].items():
        if case["kind"] == "swinunetr_icl":
            model = build_model(SwinUNETRICL, 1, case["classes"], img_size=case["patch"],
                                feature_size=case["feature_size"], window_size=(case["window"],) * 3,
                                fuse_sspa_pair=case.get("fuse", False), device="cpu",
                                generator=torch.Generator().manual_seed(0))
            for m in model.modules():
                if hasattr(m, "rate"):
                    m.rate = 0.0
        else:
            model = net_factory(case["kind"], 1, case["classes"], device="cpu",
                                patch_size=case["patch"], fuse_sspa_pair=case.get("fuse", False),
                                zero_stochastic=True)
        model.load_state_dict(case["old"], strict=True)
        model = shard_model(model.double().train(), mesh)
        metrics, state, momentum = _sharded_step(model, {}, case, mesh)
        out[name] = {"metrics": metrics, "state": state, "momentum": momentum,
                     "sharded": sorted(param_splits(model))}
    rep = job.get("replicas")
    if rep is not None:
        cfg = ExperimentConfig(**rep["cfg"])
        trainer = Trainer(cfg, device="cpu", mesh=mesh)
        for batch in rep["batches"]:
            trainer.train_step(trainer.to_device(host_slice(batch, cfg.labeled_bs, mesh.rank,
                                                            mesh.size)))
        splits = param_splits(trainer.model)
        out["replicas"] = {k: v.clone() for k, v in trainer.model.state_dict().items()
                           if k not in splits}
    refused = []
    for data, model in ((3, 1), (1, 3), (world, 2)):
        try:
            create_mesh(data=data, model=model, device="cpu")
        except ValueError as e:
            refused.append(str(e))
    out["refused"] = refused
    sw = job.get("sliding_window")
    if sw is not None:
        model = net_factory("swinunetr", 1, 2, device="cpu", feature_size=sw["feature_size"],
                            generator=torch.Generator().manual_seed(0))
        model = shard_model(model, mesh).eval()
        predict = make_fused_sliding_window(model, 2, sw["patch"], sw_batch=sw["sw_batch"],
                                            device="cpu", group=mesh.group)
        out["label_map"] = predict(sw["volume"], sw["stride"], sw["stride"])
    return out


def task_trainer(job: dict, rank: int, world: int) -> dict:
    """`Trainer.fit` over a tensor-parallel mesh of the world on the first
    2 batches, with a validation and the rolling save at step 2; then two
    restores of step 2 that go on through the other batches: of its own
    save, and of the one-process run's save under
    `job["one_process_dir"]`."""
    from icl_tpu_torch.config import ExperimentConfig
    from icl_tpu_torch.parallel.mesh import create_mesh
    from icl_tpu_torch.parallel.tensor import param_splits
    from icl_tpu_torch.train.trainer import Trainer, acdc_evaluator
    from icl_tpu_torch.utils import checkpoint as ckpt

    mesh = create_mesh(data=1, model=world, device="cpu")

    def fit(trainer, batches):
        result = trainer.fit(iter(batches), evaluate=acdc_evaluator(job["volumes"], 4,
                                                                     trainer.cfg.patch_size, "cpu"))
        return {"log": result["log"], "vals": result["vals"], "best_path": result["best_path"],
                "saves": [s["path"] for s in result["saves"]], "step_flops": result["step_flops"],
                "iteration": trainer.iteration}

    cfg = ExperimentConfig(**job["cfg"], experiments_dir=job["dir"])
    trainer = Trainer(cfg, device="cpu", mesh=mesh)
    out = {"fit": fit(trainer, job["batches"][:2]),
           "sharded": sorted(param_splits(trainer.model))}
    for name, where in (("own", job["dir"]), ("one_process", job["one_process_dir"])):
        source = ExperimentConfig(**job["cfg"], experiments_dir=where).snapshot_path
        resumed = Trainer(ExperimentConfig(**dict(job["cfg"], num_tries=f"tp_{name}"),
                                           experiments_dir=job["dir"]), device="cpu", mesh=mesh)
        resumed.load_train_state(ckpt.load_train_state(source, "step_00000002", "cpu"))
        out[f"resume_{name}"] = fit(resumed, job["batches"][resumed.iteration:])
    return out


def task_tie(job: dict, rank: int, world: int) -> dict:
    """`Trainer.fit` over a tensor-parallel mesh of the world, validating
    every step with an `evaluate` of its own whose mean dice differs by
    rank near a tie with the best so far (`job["dice"][rank]`): each rank
    deciding alone would part the model group at `save_best_model`'s
    collectives. The validations and best model each rank's fit returns."""
    from icl_tpu_torch.config import ExperimentConfig
    from icl_tpu_torch.parallel.mesh import create_mesh
    from icl_tpu_torch.train.trainer import Trainer

    mesh = create_mesh(data=1, model=world, device="cpu")
    dice = iter(job["dice"][rank])

    def evaluate(model):
        d = next(dice)
        return {"mean_dice": d, "mean_hd95": 0.0, "std_dice": 0.0, "std_hd95": 0.0,
                "class_mean": [(d, 0.0)] * 3}

    trainer = Trainer(ExperimentConfig(**job["cfg"], experiments_dir=job["dir"]), device="cpu",
                      mesh=mesh)
    result = trainer.fit(iter(job["batches"]), evaluate=evaluate)
    return {"vals": [v["mean_dice"] for v in result["vals"]], "best": result["best_mean_dice"],
            "best_path": result["best_path"]}


TASKS = {"modules": task_modules, "steps": task_steps, "trainer": task_trainer, "tie": task_tie}


if __name__ == "__main__":
    serve(TASKS)
