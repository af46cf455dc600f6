"""The port's image data layer held against the JAX package's.

* ``SyntheticImageDataset`` items are byte-equal, uint8 and f32.
* ``DistributedSampler`` index streams are integer-equal over a grid of
  dataset lengths, replica counts, ranks, shuffle, drop_last and epochs,
  and the cursor ``state_dict`` reads the same and round-trips, as does
  ``GlobalBatchSampler``'s.
* The loader's per-rank shares of each global batch, put back together,
  are the global batch (shedding the remainder that does not divide by
  the world size), and at world size 1 the batches are the JAX loader's.
* The device normalizer equals ``make_device_normalizer``'s on the same
  uint8 pixels, the flip given to both as one coin vector (JAX's coin
  from its key, handed to the port), within 2 f32 ulps of the largest
  output; the host flip draws as the JAX one for the same seed.
* ``build_train_step`` hands a generator-taking transform the step's
  augmentation stream, ``generator_for(step, AUG_TAG)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.data import DataLoader as JaxDataLoader
from pytorch_distributed_tpu.data.datasets import (
    SyntheticImageDataset as JaxSyntheticImageDataset,
)
from pytorch_distributed_tpu.data.native_pipeline import (
    device_normalizer_for as jax_device_normalizer_for,
    host_flip_transform as jax_host_flip_transform,
    make_device_normalizer as jax_make_device_normalizer,
)
from pytorch_distributed_tpu.data.sampler import (
    DistributedSampler as JaxDistributedSampler,
    GlobalBatchSampler as JaxGlobalBatchSampler,
)
from pytorch_distributed_tpu_torch.data import (
    DataLoader,
    DistributedSampler,
    GlobalBatchSampler,
    SyntheticImageDataset,
    device_normalizer_for,
    host_flip_transform,
    make_device_normalizer,
)
from pytorch_distributed_tpu_torch.data import loader as loader_mod
from pytorch_distributed_tpu_torch.runtime.prng import generator_for
from pytorch_distributed_tpu_torch.train import TrainState, build_train_step
from pytorch_distributed_tpu_torch.train.trainer import AUG_TAG
from tests.torch_parity import assert_close_ulps, assert_equal

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32],
                         ids=["uint8", "f32"])
def test_synthetic_images_are_byte_equal(dtype):
    kw = dict(n=50, image_shape=(9, 7, 3), num_classes=13, seed=4,
              dtype=dtype)
    got, want = SyntheticImageDataset(**kw), JaxSyntheticImageDataset(**kw)
    assert len(got) == len(want) == 50
    for i in (0, 1, 17, 49):
        a, b = got[i], want[i]
        assert a["image"].dtype == b["image"].dtype == np.dtype(dtype)
        assert a["image"].tobytes() == b["image"].tobytes()
        assert a["label"] == b["label"] and a["label"].dtype == np.int32
    with pytest.raises(IndexError):
        got[50]
    with pytest.raises(ValueError, match="float32 or uint8"):
        SyntheticImageDataset(dtype=np.float16)


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
def test_distributed_sampler_streams_equal_jax(shuffle, drop_last):
    for n in (1, 7, 10, 13):
        for replicas in (1, 2, 3, 4):
            for rank in range(replicas):
                kw = dict(num_replicas=replicas, rank=rank,
                          shuffle=shuffle, seed=5, drop_last=drop_last)
                got = DistributedSampler(n, **kw)
                want = JaxDistributedSampler(n, **kw)
                assert len(got) == len(want)
                for epoch in (0, 1, 2):
                    got.set_epoch(epoch)
                    want.set_epoch(epoch)
                    assert_equal(np.array(list(got), np.int64),
                                 np.array(list(want), np.int64),
                                 f"n={n} {replicas}x{rank} e{epoch}")


@pytest.mark.parametrize("kind", ["distributed", "global_batch"])
def test_cursor_state_dict_matches_jax_and_round_trips(kind):
    if kind == "distributed":
        make = lambda cls: cls(23, num_replicas=3, rank=1, seed=2)  # noqa
        classes = (DistributedSampler, JaxDistributedSampler)
    else:
        make = lambda cls: cls(23, 4, seed=2)  # noqa: E731
        classes = (GlobalBatchSampler, JaxGlobalBatchSampler)
    got, want = (make(c) for c in classes)
    for s in (got, want):
        s.set_epoch(3)
    it_got, it_want = iter(got), iter(want)
    for _ in range(3):
        next(it_got), next(it_want)
    assert got.state_dict() == want.state_dict() == {"epoch": 3, "offset": 3}
    rest = [np.asarray(x) for x in it_got]
    resumed = make(classes[0])
    resumed.load_state_dict(got.state_dict() | {"offset": 3})
    it = iter(resumed)
    assert resumed.state_dict() == {"epoch": 3, "offset": 3}
    again = [np.asarray(x) for x in it]
    assert len(again) == len(rest) > 0
    for a, b in zip(again, rest):
        assert_equal(a, b)
    assert resumed.state_dict()["offset"] == 0   # a finished epoch rewinds
    with pytest.raises(ValueError, match=">= 0"):
        resumed.load_state_dict({"epoch": 0, "offset": -1})


def test_rank_shares_make_the_global_batch(monkeypatch):
    ds = SyntheticImageDataset(n=30, image_shape=(4, 4, 3), seed=1,
                               dtype=np.uint8)
    world, batch = 3, 8     # 8 = 2 x 3 + 2: each batch sheds 2 samples
    global_batches = [b for b in DataLoader(ds, batch, seed=9)]
    shares = []
    for rank in range(world):
        monkeypatch.setattr(loader_mod.dist, "get_world_size", lambda: world)
        monkeypatch.setattr(loader_mod.dist, "get_rank", lambda r=rank: r)
        loader = DataLoader(ds, batch, seed=9, sharding="cpu")
        shares.append(list(loader))
        assert loader._warned_remainder   # the shed is logged, once
    assert all(len(s) == len(global_batches) == 30 // 8 for s in shares)
    for i, whole in enumerate(global_batches):
        for key in ("image", "label"):
            parts = [s[i][key] for s in shares]
            assert all(p.shape[0] == 2 for p in parts)
            woven = torch.stack(parts, 1).flatten(0, 1)   # rows r, r+3, ...
            assert_equal(woven, whole[key][:6], key)
    jax_batches = list(JaxDataLoader(
        JaxSyntheticImageDataset(n=30, image_shape=(4, 4, 3), seed=1,
                                 dtype=np.uint8), batch, seed=9))
    for got, want in zip(global_batches, jax_batches):
        assert_equal(got["image"], want["image"])
        assert_equal(got["label"], want["label"])
    monkeypatch.setattr(loader_mod.dist, "get_world_size", lambda: 9)
    with pytest.raises(ValueError, match="cannot be split"):
        list(DataLoader(ds, batch, seed=9))


def test_loader_surfaces_producer_errors_and_stops_early():
    class Broken:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if int(i) == 5:
                raise KeyError("bad sample 5")
            return {"x": np.zeros(2, np.float32)}

    with pytest.raises(KeyError, match="bad sample 5"):
        list(DataLoader(Broken(), 2, shuffle=False))
    loader = DataLoader(SyntheticImageDataset(n=40, image_shape=(2, 2, 1)),
                        4, prefetch=1)
    first = next(iter(loader))   # the abandoned producer is stopped
    assert first["image"].shape == (4, 2, 2, 1)


def test_device_normalizer_matches_jax_with_a_shared_coin():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(6, 5, 4, 3), dtype=np.uint8)
    labels = np.arange(6, dtype=np.int32)
    key = jax.random.key(11)
    coin = np.array(jax.random.bernoulli(key, 0.5, shape=(6,)))
    assert coin.any() and not coin.all()
    jbatch = {"image": jnp.asarray(img), "label": jnp.asarray(labels)}
    tbatch = {"image": torch.from_numpy(img),
              "label": torch.from_numpy(labels)}
    want = jax_device_normalizer_for(MEAN, STD, flip=True)(jbatch, key)
    got = device_normalizer_for(MEAN, STD, flip=True)(
        tbatch, coin=torch.from_numpy(coin))
    assert got["image"].dtype == torch.float32
    assert_close_ulps(got["image"], want["image"], 2, what="flip+normalize")
    assert_equal(got["label"], want["label"])
    want = jax_make_device_normalizer(MEAN, 1.0 / np.asarray(STD),
                                      scale=1 / 255)(jbatch)
    got = make_device_normalizer(MEAN, 1.0 / np.asarray(STD),
                                 scale=1 / 255)(tbatch)
    assert_close_ulps(got["image"], want["image"], 2, what="normalize")
    f32 = {"image": torch.ones(2, 2, 2, 3)}
    assert make_device_normalizer(MEAN, STD)(f32)["image"] is f32["image"]
    with pytest.raises(ValueError, match="3 channels but the image has 1"):
        device_normalizer_for(MEAN, STD)(
            {"image": torch.zeros(1, 2, 2, 1, dtype=torch.uint8)})
    # drawn coins: from the generator, one per image, reproducibly
    flip = device_normalizer_for(MEAN, STD, flip=True)
    a = flip(tbatch, generator_for(3, AUG_TAG, "cpu"))["image"]
    b = flip(tbatch, generator_for(3, AUG_TAG, "cpu"))["image"]
    assert torch.equal(a, b)


def test_host_flip_transform_draws_as_jax():
    rng = np.random.default_rng(1)
    img = rng.normal(size=(16, 3, 4, 2)).astype(np.float32)
    got = host_flip_transform(7)({"image": img.copy()})["image"]
    want = jax_host_flip_transform(7)({"image": img.copy()})["image"]
    assert got.tobytes() == want.tobytes()
    assert not np.array_equal(got, img)


def test_train_step_hands_the_transform_the_step_stream():
    seen = []

    def transform(batch, generator):
        seen.append(torch.rand(4, generator=generator))
        return batch

    transform._ptd_takes_rng = True
    model = torch.nn.Linear(2, 1)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1),
                       step=5)

    def loss_fn(batch, generator):
        loss = model(batch["x"]).square().mean()
        return loss, {"metrics": {"loss": loss.detach()}}

    step = build_train_step(loss_fn, batch_transform=transform)
    for _ in range(2):
        state, _ = step(state, {"x": torch.ones(3, 2)})
    for i, draw in enumerate(seen):
        want = torch.rand(4, generator=generator_for(5 + i, AUG_TAG, "cpu"))
        assert torch.equal(draw, want)
    assert not torch.equal(seen[0], seen[1])
