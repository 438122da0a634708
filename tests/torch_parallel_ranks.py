"""Rank functions of the data-mesh tests (tests/test_torch_parallel*.py),
run by ``liftreg_tpu_torch.parallel.launch`` in spawned processes:
module-level, so that they pickle, and free of JAX, so that the ranks
start fast. Each takes the rank's ``Mesh`` and plain numpy inputs and
returns numpy results."""
import torch

from liftreg_tpu_torch.losses.registration import RegNet2D3DLoss, SubspaceLoss
from liftreg_tpu_torch.losses.similarity import RankShare
from liftreg_tpu_torch.models import LiftRegSubspaceBackproj, RegNet2D3D
from liftreg_tpu_torch.models.legacy_blocks import ResBlock2D
from liftreg_tpu_torch.parallel import attach, shard_batch
from liftreg_tpu_torch.train.trainer import loss_and_grads

#: the subspace loss of the step tests (tests/torch_train_data.py's)
LOSS_OPT = {"sim_class": "ncc", "initial_reg_factor": 0.01,
            "min_reg_factor": 0.01}
REG_FACTOR = 0.01
#: RegNet2D3D's re-projections, min-max normalised over the batch
REGNET_PROJECTIONS = ("warped_proj", "warped_proj_inv", "source_proj")
#: the narrow RegNet2D3D of the step tests
REGNET_WIDTHS = {"enc_filters": (4, 4, 4, 4, 4),
                 "dec_filters": (4, 4, 4, 4, 4, 4), "inverse_iters": 2}


def _np(tree):
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def _threads():
    # the ranks of a test share the test worker's cores
    torch.set_num_threads(2)


def _weights(mesh, target_b, n_valid):
    w = (torch.arange(target_b) < n_valid).float()
    return RankShare(w[mesh.rows(target_b)], float(n_valid), mesh.size)


def subspace_step(mesh, case, weights=None):
    """One step's global losses and gradients of LiftRegSubspaceBackproj
    on this rank's rows of ``case["batch"]`` (padded to a multiple of the
    ranks, ``case["n_valid"]`` real rows), and the collective bytes and
    calls of the step."""
    model = LiftRegSubspaceBackproj(case["sz"], latent_dim=case["latent"],
                                    drr_feature_num=case["views"])
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in case["state"].items()})
    target_b = case["batch"]["source"].shape[0]
    if weights is None:
        weights = _weights(mesh, target_b, case["n_valid"])
    bytes0, calls0 = mesh.collective_bytes, mesh.collective_calls
    losses, grads = loss_and_grads(
        model, SubspaceLoss(LOSS_OPT), dict(model.named_parameters()),
        shard_batch(case["batch"], mesh),
        {k: torch.from_numpy(v) for k, v in case["pca"].items()},
        REG_FACTOR, weights, mesh)
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": _np(grads),
            "bytes": mesh.collective_bytes - bytes0,
            "calls": mesh.collective_calls - calls0}


def step_suite(mesh, cases, controls=None):
    """:func:`subspace_step` of each case; with ``controls`` (a case) also
    the batch-norm, extremes and RegNet2D3D checks of
    :func:`controls_suite`."""
    _threads()
    out = {"steps": [subspace_step(mesh, c) for c in cases]}
    if controls is not None:
        out.update(controls_suite(mesh, controls))
    return out


def controls_suite(mesh, c):
    """The step of ``c["step"]`` with its pad rows weighted 1 (a negative
    control), a ResBlock2D train step (batch norm), the extremes of a tensor
    with ties across the ranks, and one RegNet2D3D loss and gradient."""
    step = c["step"]
    b = step["batch"]["source"].shape[0] // mesh.size
    pad_one = subspace_step(mesh, step, RankShare(
        torch.ones(b), float(b * mesh.size), mesh.size))
    return {"pad_weighted_one": pad_one, "batch_norm": batch_norm(mesh, c),
            "extremes": extremes(mesh, c["extremes"]),
            "regnet": regnet_step(mesh, c["regnet"])}


def _all_reduce_grads(mesh, params):
    flat = mesh.all_reduce(torch.cat([p.grad.reshape(-1)
                                      for p in params.values()]))
    return {k: f.view_as(p).numpy() for (k, p), f in zip(
        params.items(), flat.split([p.numel() for p in params.values()]))}


def batch_norm(mesh, c):
    """ResBlock2D in training on this rank's rows of ``c["bn_x"]`` (padded,
    ``c["bn_valid"]`` real rows): the gathered output, the running
    averages, and the gradient of sum(out * cot) over the real rows."""
    x = torch.from_numpy(c["bn_x"])
    block = ResBlock2D(x.shape[1], c["bn_features"])
    block.load_state_dict({k: torch.from_numpy(v)
                           for k, v in c["bn_state"].items()})
    attach(block, mesh)
    rows = mesh.rows(x.shape[0])
    out = block(x[rows], train=True)
    cot = torch.from_numpy(c["bn_cot"])[rows]
    (out * cot).sum().backward()
    params = dict(block.named_parameters())
    return {"out": mesh.gather_rows(out.detach()).numpy(),
            "state": _np(block.state_dict()),
            "grads": _all_reduce_grads(mesh, params)}


def extremes(mesh, x):
    """``mesh.extremes`` of this rank's rows of ``x`` and the gradient of
    ``2 lo + 3 hi`` (each rank backpropagates its share, 1 / size of it),
    gathered."""
    x = torch.from_numpy(x)[mesh.rows(x.shape[0])].requires_grad_(True)
    lo, hi = mesh.extremes(x)
    ((2 * lo + 3 * hi) / mesh.size).backward()
    return {"lo": float(lo), "hi": float(hi),
            "grad": mesh.gather_rows(x.grad).numpy()}


def small_regnet(c):
    """A RegNet2D3D of :data:`REGNET_WIDTHS` with ``c["state"]``'s
    weights."""
    model = RegNet2D3D(c["sz"], drr_feature_num=c["views"], **REGNET_WIDTHS)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in c["state"].items()})
    return model


def regnet_step(mesh, c):
    """RegNet2D3D's global loss and gradients on this rank's rows of
    ``c["batch"]``, and its re-projections (normalised over the global
    batch) gathered. The loss's NCC is blind to the normalisation: the
    re-projections are what shows its extremes."""
    model = attach(small_regnet(c), mesh)
    target_b = c["batch"]["source"].shape[0]
    batch = shard_batch(c["batch"], mesh)
    losses, grads = loss_and_grads(
        model, RegNet2D3DLoss(LOSS_OPT), dict(model.named_parameters()),
        batch, None, REG_FACTOR, _weights(mesh, target_b, c["n_valid"]),
        mesh)
    with torch.no_grad():
        out = model(batch)
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": _np(grads),
            "projections": {k: mesh.gather_rows(out[k]).numpy()
                            for k in REGNET_PROJECTIONS}}


def train_and_resume(mesh, cfg, resume_cfg):
    """The trainer on this rank for ``cfg``'s epochs, then a new trainer
    resuming from ``resume_cfg``'s checkpoint for one more; returns the
    resumed epoch and steps, the final steps and the parameters."""
    from liftreg_tpu_torch.train import RegistrationTrainer
    _threads()
    RegistrationTrainer(cfg, n_devices=mesh.size, device="cpu").run()
    tr = RegistrationTrainer(resume_cfg, n_devices=mesh.size, device="cpu")
    resumed = {"start_epoch": tr.start_epoch,
               "global_step": dict(tr.global_step)}
    tr.run()
    return {"resumed": resumed, "global_step": dict(tr.global_step),
            "params": _np(tr.model.state_dict())}


def _rows(mesh, arrays):
    return [torch.from_numpy(a[mesh.rows(a.shape[0])]) for a in arrays]


def _gathered(mesh, res, rows):
    """A refiner's result with the rows of the keys in ``rows`` gathered."""
    return {k: (mesh.gather_rows(v).numpy() if k in rows
                else v if k == "steps_run" else v.numpy())
            for k, v in res.items()}


def refine_suite(mesh, case):
    """On this rank's rows: ``make_refiner`` with the mesh (its outputs'
    rows gathered), the same refiner with no collective (each rank's early
    stop its own: a negative control), ``make_projection_refiner`` with
    the mesh (``proj_norm="minmax"``) and with no collective (each rank's
    extremes its own: a negative control), a refined
    ``RegistrationPipeline.register`` with the mesh, and a
    ``DenseRegisterer`` with the mesh (bf16 taps)."""
    from liftreg_tpu_torch import RegistrationPipeline
    from liftreg_tpu_torch.optreg import DenseRegisterer
    from liftreg_tpu_torch.parallel import Mesh
    from liftreg_tpu_torch.refine import make_projection_refiner, make_refiner
    _threads()
    pca = {k: torch.from_numpy(v) for k, v in case["pca"].items()}
    z0, moving, target = _rows(mesh, case["refine_inputs"])
    res = make_refiner(case["img"], mesh=mesh, **case["refine_opts"])(
        z0, pca, moving, target)
    out = {"refiner": _gathered(mesh, res, case["rows"])}
    alone = make_refiner(case["img"],
                         mesh=Mesh(mesh.rank, mesh.size, mesh.device),
                         **case["refine_opts"])(z0, pca, moving, target)
    out["rank_local_steps_run"] = alone["steps_run"]
    proj = case["projection"]
    z0, atten, target = _rows(mesh, proj["inputs"])
    res = make_projection_refiner(
        case["img"], proj["poses"], proj["res"], proj["spacing"], mesh=mesh,
        **proj["opts"])(z0, {k: torch.from_numpy(v)
                             for k, v in proj["pca"].items()}, atten, target)
    out["projection"] = _gathered(mesh, res, case["rows"])
    alone = make_projection_refiner(
        case["img"], proj["poses"], proj["res"], proj["spacing"],
        mesh=Mesh(mesh.rank, mesh.size, mesh.device), **proj["opts"])(
        z0, {k: torch.from_numpy(v) for k, v in proj["pca"].items()}, atten,
        target)
    out["rank_local_projection_coefs"] = mesh.gather_rows(
        alone["coefs"]).numpy()
    pipe = RegistrationPipeline(case["img"], mesh=mesh,
                                **case["pipeline_opts"])
    pipe.model.load_state_dict({k: torch.from_numpy(v)
                                for k, v in case["state"].items()})
    ppca = {k: torch.from_numpy(v) for k, v in case["pipeline_pca"].items()}
    warped, phi = pipe.register(ppca, *_rows(mesh, case["pipeline_inputs"]))
    out["pipeline"] = {"warped": mesh.gather_rows(warped).numpy(),
                       "phi": mesh.gather_rows(phi).numpy(),
                       "steps_run": pipe.last_refine["steps_run"]}
    opt = case["optreg"]
    res = DenseRegisterer(opt["img"], levels=opt["levels"],
                          warp_taps_dtype=torch.bfloat16, mesh=mesh)(
        *_rows(mesh, opt["inputs"]))
    out["optreg"] = {k: (mesh.gather_rows(v) if k in case["rows"] + ("z",
                                                                "disp")
                         else v).numpy() for k, v in res.items()}
    return out
