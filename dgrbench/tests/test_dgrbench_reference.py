"""The plain reference against the program at a small size, on the CPU.

This file may import both; the reference itself imports nothing of the
program. Tolerances: both sides compute in float32 with the sums in other
orders, so features and logits agree to a few units of 1e-6 relative."""

import numpy as np
import pytest
import torch

from dgrbench.reference import geometry, judge, resunet, sparse, train
from dgrbench.reference import weights as ref_weights
from dgrbench.traffic import pairs
from dgrbench.drivers import common

from deepglobalregistration_tpu_torch.core import registration
from deepglobalregistration_tpu_torch.core import pipeline
from deepglobalregistration_tpu_torch.models import load_model
from deepglobalregistration_tpu_torch.models.unet_plan import build_unet_plan
from deepglobalregistration_tpu_torch.ops import icp as icp_ops
from deepglobalregistration_tpu_torch.ops import kernel_map, knn, sparse_grid
from deepglobalregistration_tpu_torch.utils import checkpoint

ROOM = {"scene": "room", "points": 2500, "keep": [0.7, 0.9], "rotation_deg": 360}
PKL = common.repo_path("weights/fcgf_synthetic.pkl")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return pairs.pair(2 ** 31 + 5, 0, ROOM)


def test_voxelize_matches_both_program_paths(pair):
    from deepglobalregistration_tpu_torch import native
    xyz = pair["xyz0"]
    idx, c = sparse.voxelize(xyz, 0.05)
    sel, grid = sparse_grid.voxelize(torch.as_tensor(xyz), 0.05, 0)
    assert torch.equal(torch.as_tensor(xyz[idx]), sel)
    assert np.array_equal(c, grid[:, 1:].numpy())
    p, c64 = native.voxelize(xyz, 0.05)
    bad, _, _ = judge.voxel_mismatch(xyz, 0.05, torch.as_tensor(p), torch.as_tensor(c64),
                                     "float64")
    assert bad == 0


@pytest.mark.parametrize("ndim,ks,unit", [(3, 3, 1), (3, 5, 2), (6, 3, 1)])
def test_kernel_map_edges(pair, ndim, ks, unit):
    c = torch.as_tensor(sparse.voxelize(pair["xyz0"], 0.1)[1])
    if ndim == 6:
        c = torch.cat([c, c.flip(0)], 1)
    g = torch.cat([torch.zeros_like(c[:, :1]), c * unit], 1)
    mine = sparse.kernel_map(g, g, sparse.hypercube_offsets(ks, ndim), unit)
    theirs = kernel_map.build_kernel_map(g, g, kernel_map.kernel_offsets(ks, ndim), unit)
    key = lambda k, i, o: set(zip(k.tolist(), i.tolist(), o.tolist()))
    assert key(mine.k, mine.inp, mine.out) == key(theirs.k, theirs.inp, theirs.out)


def test_weights_reader_matches_the_program():
    mine = ref_weights.load(PKL)["state_dict"]
    theirs = checkpoint.load_checkpoint(PKL)["state_dict"]
    a, b = resunet.leaves(mine["params"]), resunet.leaves(theirs["params"])
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k].numpy(), np.asarray(b[k], np.float32)), k


def _program_net(name, arch, tree, fold):
    spec = load_model(name)
    cfg = spec.make_config(arch.in_channels, arch.out_channels,
                           conv1_kernel_size=arch.conv1_kernel_size,
                           normalize_feature=arch.normalize, D=arch.ndim)
    return pipeline.build_net(spec, common.numpy_tree(tree), cfg, fold, torch.float32,
                              torch.device("cpu"))


def test_fcgf_features(pair):
    arch = resunet.Arch("ResUNetBN2C", 1, 32, 7, 3, True)
    sd = ref_weights.load(PKL)["state_dict"]
    tree = (sd["params"], sd["state"])
    c0 = torch.as_tensor(sparse.voxelize(pair["xyz0"], 0.05)[1])
    c1 = torch.as_tensor(sparse.voxelize(pair["xyz1"], 0.05)[1])
    mine = judge.features(tree, arch, [c0, c1])
    net = _program_net("ResUNetBN2C", arch, tree, True)
    grid = torch.cat([torch.cat([torch.full_like(c[:, :1], i), c], 1)
                      for i, c in enumerate((c0, c1))])
    plan = build_unet_plan(grid, 2, 7, net.cfg.region_type, net.cfg.levels, ones_input=True)
    with torch.no_grad():
        theirs = net(plan, torch.ones((grid.shape[0], 1))).split([len(c0), len(c1)])
    for a, b in zip(mine, theirs):
        assert (a - b).abs().max() < 1e-5


def test_inlier_logits_and_match(pair):
    arch = resunet.Arch("ResUNetBN2F", 1, 1, 3, 6, False)
    tree = resunet.init_tree(arch, torch.Generator().manual_seed(3), "cpu")
    c0 = torch.as_tensor(sparse.voxelize(pair["xyz0"], 0.1)[1])
    c1 = torch.as_tensor(sparse.voxelize(pair["xyz1"], 0.1)[1])
    f = torch.randn(len(c0) + len(c1), 8, generator=torch.Generator().manual_seed(4))
    f0, f1 = f[:len(c0)], f[len(c0):]
    idx, d2 = geometry.nn1(f0, f1)
    pidx, pd2 = knn.find_nn_plain(f0, f1, len(f0), len(f1))
    assert geometry.nn_gap(f0, f1, pidx.long()) < 1e-5
    assert torch.allclose(d2, pd2, atol=1e-5)
    mine = judge.logits6(tree, arch, c0, c1, idx)
    net = _program_net("ResUNetBN2F", arch, tree, True)
    g6 = torch.cat([torch.zeros_like(c0[:, :1]), c0, c1[idx]], 1)
    plan = build_unet_plan(g6, 1, 3, net.cfg.region_type, net.cfg.levels)
    with torch.no_grad():
        theirs = net(plan, torch.ones((len(c0), 1)))[:, 0]
    assert (mine - theirs).abs().max() / max(1.0, float(mine.abs().max())) < 1e-5


def _scene():
    g = torch.Generator().manual_seed(0)
    X = torch.randn(800, 3, generator=g) * 3
    R = geometry.rot6d_to_matrix(torch.randn(6, generator=g))
    Y = X @ R.T + torch.tensor([0.3, -0.2, 0.1]) + 0.02 * torch.randn(800, 3, generator=g)
    Y[::4] = torch.randn(200, 3, generator=g) * 3
    w = torch.rand(800, generator=g)
    return X, Y, torch.where(w < 0.05, torch.zeros_like(w), w)


def test_refinement_and_its_stop():
    X, Y, w = _scene()
    a = registration.global_registration(X, Y, w, break_threshold_ratio=1e-4,
                                         quantization_size=0.1)
    b = geometry.refine(X, Y, w, quant=0.1)
    c = geometry.refine(X, Y, w, quant=0.1, steps=a.iterations)
    Ta, Tc = torch.eye(4), torch.eye(4)
    Ta[:3, :3], Ta[:3, 3], Tc[:3, :3], Tc[:3, 3] = a.R, a.t, c.R, c.t
    assert abs(a.iterations - b.iterations) <= 1
    rot, tr = geometry.pose_gap(Ta, Tc)
    assert rot < 1e-3 and tr < 1e-5


def test_icp_at_the_programs_steps():
    X, Y, _ = _scene()
    init = torch.eye(4)
    init[:3, 3] = torch.tensor([0.05, 0.0, -0.03])
    Ys = X @ geometry.rot6d_to_matrix(torch.tensor([1.0, 0.02, 0, 0, 1, 0])).T + 0.1
    a = icp_ops.registration_icp(X, Ys, 0.3, init=init)
    b = geometry.icp(X, Ys, 0.3, init, steps=a.iterations)
    rot, tr = geometry.pose_gap(a.T, b.T)
    assert rot < 1e-3 and tr < 1e-5


def test_positives_and_labels():
    from deepglobalregistration_tpu_torch import native
    p = pairs.pair(11, 0, ROOM)
    p0, c0 = native.voxelize(p["xyz0"], 0.05)
    p1, c1 = native.voxelize(p["xyz1"], 0.05)
    T = p["T"].astype(np.float32)
    theirs = native.radius_pairs(p0, p1, T, 0.2)
    mine = train.positives(torch.as_tensor(p0), torch.as_tensor(p1), torch.as_tensor(T), 0.2)
    assert set(map(tuple, theirs.tolist())) == set(map(tuple, mine.tolist()))


def test_training_step(tmp_path):
    """One step of the program's train step against the reference's."""
    from deepglobalregistration_tpu_torch import native
    from deepglobalregistration_tpu_torch.config import default_config
    from deepglobalregistration_tpu_torch.core import train_step as ts
    from deepglobalregistration_tpu_torch.data import collate
    from deepglobalregistration_tpu_torch.utils import convert
    fa = resunet.Arch("ResUNetBN2C", 1, 32, 7, 3, True)
    ia = resunet.Arch("ResUNetBN2F", 1, 1, 3, 6, False)
    sd = ref_weights.load(PKL)["state_dict"]
    ftree, itree = (sd["params"], sd["state"]), resunet.init_tree(
        ia, torch.Generator().manual_seed(9), "cpu")
    pc = default_config(voxel_size=0.1, lr=0.1)
    raw = [pairs.pair(21, i, dict(ROOM, scale=[0.8, 1.2], scale_prob=0.95)) for i in range(2)]
    items = []
    for r in raw:
        r["radius"] = 0.4 * r["scale"]
        p0, c0 = native.voxelize(r["xyz0"], 0.1)
        p1, c1 = native.voxelize(r["xyz1"], 0.1)
        m = native.radius_pairs(p0, p1, r["T"].astype(np.float32), r["radius"])
        items.append((p0, p1, c0, c1, None, None, m, r["T"].astype(np.float32), {}))
    hb = collate.make_pair_batch(items)
    fcgf = _program_net("ResUNetBN2C", fa, ftree, False)
    spec = load_model("ResUNetBN2F")
    icfg = spec.make_config(1, 1, conv1_kernel_size=3, normalize_feature=False, D=6)
    inlier = spec.module(icfg)
    inlier.load_state_dict(convert.from_jax_params(*common.numpy_tree(itree), icfg))
    inlier.train()
    opt = ts.make_optimizer("SGD", inlier.parameters(), pc)
    step, _ = ts.make_train_step(fcgf, inlier, pc, opt)
    stats = step(ts.batch_to(hb, "cpu"))
    nn = [stats["nn_idx"][p, :n] for p, n in enumerate(hb.num0.tolist())]
    pis = []
    for p, r in enumerate(raw):
        s0 = torch.as_tensor(hb.xyz0[p, :hb.num0[p]])
        s1 = torch.as_tensor(hb.xyz1[p, :hb.num1[p]])
        T = torch.as_tensor(r["T"], dtype=torch.float32)
        lab = train.labels_of(train.positives(s0, s1, T, r["radius"]), nn[p].long(), len(s1))
        pis.append(train.PairInput(s0, s1, torch.as_tensor(hb.coords0[p, :hb.num0[p]]).long(),
                                   torch.as_tensor(hb.coords1[p, :hb.num1[p]]).long(),
                                   nn[p].long(), lab, T))
    cfg = {k: getattr(pc, k) for k in ("clip_weight_thresh", "trans_weight",
                                       "procrustes_loss_weight", "inlier_direct_loss_weight",
                                       "lr", "sgd_momentum", "sgd_dampening", "weight_decay")}
    losses, logits, bufs, params, _ = train.follow(itree[0], itree[1], ia, [pis], cfg)
    assert abs(losses[0] - float(stats["loss"])) < 1e-5 * abs(losses[0])
    lab = torch.cat([p.labels for p in pis])
    got = torch.cat([stats["labels"][p, :n] for p, n in enumerate(hb.num0.tolist())])
    assert torch.equal(got.float(), lab)
    state = opt.state
    for n, p in inlier.named_parameters():
        b = state[p]["momentum_buffer"]
        assert (b - bufs[n]).norm() <= 1e-4 * max(float(bufs[n].norm()), 1e-12) + 1e-7, n
        assert (p.detach() - params[n]).abs().max() < 1e-5, n
