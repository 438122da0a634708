"""The port's datasets and loaders against liftreg_tpu's on the CPU, on one
small on-disk dataset (tests/torch_train_data.py): every sample of every
split bit-equal for both dataset classes, the same batch order from the
shuffling loaders over several epochs, the card-resident cache's batches
(here on the CPU) with their padding, ``pad_batch`` on numpy arrays and on
tensors, the registry, and ``compress_in_memory`` refused. All exact."""
import numpy as np
import pytest
import torch

from liftreg_tpu.data import dataset as jdata
from liftreg_tpu.parallel import mesh as jmesh
from liftreg_tpu_torch.data import dataset as tdata

from torch_train_data import setting, write_dataset


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return write_dataset(str(tmp_path_factory.mktemp("torch_data")), sz=8,
                         n_train=5, n_val=3, n_test=2, views=3)


def _option(root, **more):
    opt = setting(root, "unused", sz=8, views=3)["dataset"]
    opt.update(more)
    return opt


@pytest.mark.parametrize("cls", ["registration2d3d",
                                 "registration2d3d_projloss"])
@pytest.mark.parametrize("phase", ["train", "val", "test", "debug"])
def test_samples_bit_equal(data_root, cls, phase):
    opt = _option(data_root, load_projection_interval=2)
    jd = jdata.get_dataset(cls)(data_root, phase=phase, option=opt)
    td = tdata.get_dataset(cls)(data_root, phase=phase, option=opt)
    assert len(td) == len(jd) > 0
    for i in range(len(jd) + 1):         # the index wraps
        (js, jn), (ts, tn) = jd[i], td[i]
        assert tn == jn
        assert set(ts) == set(js)
        for k in js:
            assert ts[k].dtype == js[k].dtype, k
            np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


def test_registry_and_limits(data_root):
    assert set(tdata.DATASET_REGISTRY) == set(jdata.DATASET_REGISTRY)
    with pytest.raises(KeyError):
        tdata.get_dataset("nope")
    opt = _option(data_root, max_num_for_loading=[2, -1, -1, -1])
    assert len(tdata.Registration2D3DDataset(data_root, "train", option=opt)) \
        == 2
    # compress_in_memory (the native codec, ROADMAP A5) keeps each case
    # packed and gives the same samples
    packed = tdata.Registration2D3DDataset(
        data_root, "train", option=_option(data_root,
                                           compress_in_memory=True))
    plain = tdata.Registration2D3DDataset(data_root, "train",
                                          option=_option(data_root))
    assert isinstance(packed.cases[0]["source"][1], bytes)
    (ps, pn), (qs, qn) = packed[1], plain[1]
    assert pn == qn and set(ps) == set(qs)
    for k in qs:
        np.testing.assert_array_equal(ps[k], qs[k], err_msg=k)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False),
                                               (False, False)])
def test_loader_order(data_root, shuffle, drop_last):
    opt = _option(data_root)
    jd = jdata.Registration2D3DDataset(data_root, "train", option=opt)
    td = tdata.Registration2D3DDataset(data_root, "train", option=opt)
    jl = jdata.DataLoader(jd, batch_size=2, shuffle=shuffle,
                          drop_last=drop_last)
    tl = tdata.DataLoader(td, batch_size=2, shuffle=shuffle,
                          drop_last=drop_last)
    assert len(tl) == len(jl)
    for _ in range(3):
        jb, tb = list(jl), list(tl)
        assert [n for _, n in tb] == [n for _, n in jb]
        for (ja, _), (ta, _) in zip(jb, tb):
            for k in ja:
                np.testing.assert_array_equal(ta[k], ja[k])


def test_device_loader_pads(data_root):
    """The card-resident loader (on the CPU here): the JAX loader's order,
    every batch padded to pad_to by repeating its last sample, names only
    of the real samples."""
    opt = _option(data_root)
    jd = jdata.Registration2D3DDataset(data_root, "val", option=opt)
    td = tdata.Registration2D3DDataset(data_root, "val", option=opt)
    jl = jdata.DeviceDataLoader(jdata.DeviceDatasetCache(jd), batch_size=2,
                                shuffle=True, pad_to=2)
    cache = tdata.DeviceDatasetCache(td, device="cpu")
    assert cache.nbytes == sum(v.numel() * v.element_size()
                               for v in cache.arrays.values())
    tl = tdata.DeviceDataLoader(cache, batch_size=2, shuffle=True, pad_to=2)
    for _ in range(2):
        jb, tb = list(jl), list(tl)
        assert [n for _, n in tb] == [n for _, n in jb]
        assert [len(n) for _, n in tb] == [2, 1]
        for (ja, _), (ta, _) in zip(jb, tb):
            for k in ja:
                assert ta[k].shape[0] == 2
                np.testing.assert_array_equal(ta[k].numpy(),
                                              np.asarray(ja[k]))
        last = tb[-1][0]["source"]
        assert torch.equal(last[0], last[1])


@pytest.mark.parametrize("as_tensor", [False, True])
def test_pad_batch(as_tensor):
    rng = np.random.default_rng(2)
    batch = {"source": rng.standard_normal((3, 1, 2, 2, 2)).astype(np.float32),
             "target_poses": rng.standard_normal((3, 4, 3)).astype(np.float32),
             "scalar": 7}
    want, n_valid = jmesh.pad_batch(batch, 5)
    given = {k: torch.from_numpy(v) if as_tensor and hasattr(v, "ndim")
             else v for k, v in batch.items()}
    got, n = tdata.pad_batch(given, 5)
    assert n == n_valid == 3
    for k, v in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        np.testing.assert_array_equal(g, v)
    same, n = tdata.pad_batch(given, 3)
    assert same is given and n == 3
    with pytest.raises(ValueError):
        tdata.pad_batch(given, 2)
