"""``--use_grain`` on torch's DataLoader (``data/grain_pipeline.py``) ≡ the
JAX package's grain DataLoader (``learnablepoolingmethods_tpu/data/
grain_pipeline.py``): the same batches in the same order, shuffled or
not, over two epochs, with 0 and 2 worker processes; grain's own
index_shuffle and sharding as the oracle of the order."""

import pickle

import grain.python as gp
import numpy as np
import pytest
from grain._src.python.dataset.transformations import shuffle as grain_shuffle

from learnablepoolingmethods_tpu.data import grain_pipeline as jgrain
from learnablepoolingmethods_torch.data import fixtures, grain_pipeline
from learnablepoolingmethods_torch.data.readers import YT8MFrameFeatureReader

V, SIZES, MAXF = 15, (8, 4), 10


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("grain")
    for i, n in enumerate((6, 5)):
        fixtures.write_frame_level_fixture(str(d / f"g-{i}.tfrecord"), n, num_classes=V, rgb_size=8, audio_size=4,
                                           max_frames=MAXF, seed=6 + i)
    fixtures.write_video_level_fixture(str(d / "v.tfrecord"), 12, num_classes=V, rgb_size=8, audio_size=4)
    return {"frames": str(d / "g-*.tfrecord"), "videos": str(d / "v.tfrecord")}


@pytest.mark.parametrize("n", [1, 2, 3, 11, 500, 70_000])
def test_index_shuffle_is_grains(n):
    # 70,000 records take 18-bit blocks, the rest grain's least, 16
    for seed in (0, 5, 2 ** 32 - 1) if n <= 500 else (9,):
        positions = range(n) if n <= 500 else range(0, n, 997)
        perm = grain_pipeline.index_shuffle_permutation(n, seed)
        assert [perm[i] for i in positions] == [
            grain_shuffle.index_shuffle.index_shuffle(i, max_index=n - 1, seed=seed, rounds=4) for i in positions]
        assert sorted(perm) == list(range(n))


class _Keys:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.int64(i)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("shard", [(0, 1), (0, 3), (2, 3)])
def test_record_keys_follow_grains_sampler_and_sharding(shuffle, shard):
    n, epochs = 11, 2
    options = gp.ShardOptions(shard_index=shard[0], shard_count=shard[1], drop_remainder=False)
    sampler = gp.IndexSampler(num_records=n, num_epochs=epochs, shard_options=options, shuffle=shuffle, seed=7)
    loader = gp.DataLoader(data_source=_Keys(n), sampler=sampler, worker_count=0, shard_options=options)
    want = [int(k) for k in loader]
    assert list(grain_pipeline.grain_record_keys(n, epochs, shuffle, 7, *shard)) == want
    endless = grain_pipeline.grain_record_keys(n, None, shuffle, 7, *shard)
    assert [next(endless) for _ in range(len(want))] == want


def test_source_items_equal_jax_and_the_reader(data):
    port = grain_pipeline.TFRecordRandomAccessSource(data["frames"], True, SIZES, num_classes=V, max_frames=MAXF)
    jax_src = jgrain.TFRecordRandomAccessSource(data["frames"], True, SIZES, num_classes=V, max_frames=MAXF)
    reader = YT8MFrameFeatureReader(V, SIZES, ("rgb", "audio"), MAXF)
    records = list(reader.read_pattern(data["frames"]))
    # a pickled copy (what a worker process gets) reads the same
    copy = pickle.loads(pickle.dumps(port))
    assert len(port) == len(jax_src) == len(copy) == len(records) == 11
    for i in (3, 0, 10, 3):
        for got in (port[i], copy[i]):
            for k, want in jax_src[i].items():
                assert np.asarray(got[k]).dtype == np.asarray(want).dtype
                np.testing.assert_array_equal(got[k], want, err_msg=k)
                np.testing.assert_array_equal(got[k], records[i][k], err_msg=k)


def _assert_batches_equal(got, want, frame_level=True):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["video_id"] == [bytes(v) for v in w["video_id"]]
        for k in ("features", "labels", "weights") + (("num_frames",) if frame_level else ()):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("shuffle", [False, True])
def test_batches_equal_jax_grain(data, shuffle, workers):
    kw = dict(num_epochs=2, shuffle=shuffle, seed=5, worker_count=workers, feature_sizes=SIZES, num_classes=V,
              max_frames=MAXF)
    got = list(grain_pipeline.grain_batch_iterator(data["frames"], 3, True, **kw))
    want = list(jgrain.grain_batch_iterator(data["frames"], 3, True, shard_by_process=False, **kw))
    _assert_batches_equal(got, want)
    ids = [v for b in got for v in b["video_id"]]
    assert sorted(ids) == sorted(2 * [r["video_id"] for r in YT8MFrameFeatureReader(
        V, SIZES, ("rgb", "audio"), MAXF).read_pattern(data["frames"])])
    if shuffle or workers == 0:
        # in the file order unless shuffled (workers interleave it)
        assert (ids[:11] != sorted(ids[:11])) == shuffle
    assert got[-1]["features"].shape[0] < 3


def test_video_level_batches_equal_jax_grain(data):
    kw = dict(num_epochs=1, shuffle=True, seed=1, feature_sizes=SIZES, num_classes=V,
              feature_names=("mean_rgb", "mean_audio"))
    got = list(grain_pipeline.grain_batch_iterator(data["videos"], 5, False, **kw))
    want = list(jgrain.grain_batch_iterator(data["videos"], 5, False, shard_by_process=False, **kw))
    _assert_batches_equal(got, want, frame_level=False)
