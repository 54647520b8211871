"""The port's C++ reader and CSV formatter (``data/native_loader.py``, its
own copies of the sources) ≡ the JAX package's binding
(``learnablepoolingmethods_tpu/data/native_loader.py``) and the port's
Python reader, array for array; the formatter ≡ ``format_lines`` byte for
byte.  Also: the build is one library per source hash that processes
building at once all load, and a failed build raises (no fallback)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from learnablepoolingmethods_tpu.data import native_loader as jnative
from learnablepoolingmethods_tpu.data import pipeline as jpipeline
from learnablepoolingmethods_tpu.utils.misc import format_lines as jformat_lines
from learnablepoolingmethods_torch.data import fixtures, native_loader, pipeline
from learnablepoolingmethods_torch.data.readers import YT8MAggregatedFeatureReader, YT8MFrameFeatureReader
from learnablepoolingmethods_torch.utils.misc import format_lines

ROOT = Path(__file__).resolve().parents[1]
V, SIZES, MAXF = 25, (8, 4), 16
FRAME_KW = dict(max_frames=MAXF, feature_sizes=SIZES, feature_names=("rgb", "audio"), num_classes=V)
VIDEO_KW = dict(feature_sizes=SIZES, feature_names=("mean_rgb", "mean_audio"), num_classes=V)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    frames = str(d / "f.tfrecord")
    fixtures.write_frame_level_fixture(frames, 11, num_classes=V, rgb_size=8, audio_size=4, max_frames=40, seed=5)
    videos = str(d / "v.tfrecord")
    fixtures.write_video_level_fixture(videos, 9, num_classes=V, rgb_size=8, audio_size=4, seed=6)
    shards = fixtures.write_frame_level_shards(str(d / "shards"), 40, num_shards=3, num_classes=V, rgb_size=8,
                                               audio_size=4, max_frames=MAXF, min_frames=1, seed=3)
    return {"frames": frames, "videos": videos, "shards": shards, "dir": d}


def _assert_parse_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        if k == "video_id":
            assert got[k] == want[k]
        else:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("level", ["frame", "video"])
def test_file_parse_equals_jax_and_the_python_reader(data, level):
    if level == "frame":
        got = native_loader.parse_frame_file(data["frames"], **FRAME_KW)
        want = jnative.parse_frame_file(data["frames"], **FRAME_KW)
        reader = YT8MFrameFeatureReader(V, SIZES, ("rgb", "audio"), MAXF)
        path = data["frames"]
    else:
        got = native_loader.parse_video_file(data["videos"], **VIDEO_KW)
        want = jnative.parse_video_file(data["videos"], **VIDEO_KW)
        reader = YT8MAggregatedFeatureReader(V, SIZES, ("mean_rgb", "mean_audio"))
        path = data["videos"]
    _assert_parse_equal(got, want)
    records = list(reader.read_file(path))
    assert native_loader.count_records(path) == len(records) == len(got["video_id"])
    for i, rec in enumerate(records):
        for k, v in rec.items():
            if k == "video_id":
                assert got[k][i] == v
            else:
                np.testing.assert_array_equal(got[k][i], v, err_msg=k)


def test_record_parse_equals_jax(data):
    from learnablepoolingmethods_torch.data import tfrecord_io

    for rec in tfrecord_io.read_tfrecords(data["frames"]):
        got = native_loader.parse_frame_record(rec, MAXF, SIZES)
        want = jnative.parse_frame_record(rec, MAXF, SIZES)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    for rec in tfrecord_io.read_tfrecords(data["videos"]):
        np.testing.assert_array_equal(native_loader.parse_video_record(rec, SIZES),
                                      jnative.parse_video_record(rec, SIZES))
    # garbage parses as JAX's does: to the same arrays, or ValueError in both
    rng = np.random.default_rng(1)
    for blob in [b"", b"\x0a\xff"] + [rng.bytes(int(n)) for n in rng.integers(1, 200, 20)]:
        for fn, jfn in ((native_loader.parse_frame_record, jnative.parse_frame_record),
                        (native_loader.parse_video_record, jnative.parse_video_record)):
            try:
                want = jfn(blob, feature_sizes=SIZES)
            except ValueError:
                with pytest.raises(ValueError, match="malformed record"):
                    fn(blob, feature_sizes=SIZES)
                continue
            got = fn(blob, feature_sizes=SIZES)
            np.testing.assert_array_equal(got[0] if isinstance(got, tuple) else got,
                                          want[0] if isinstance(want, tuple) else want)


@pytest.mark.parametrize("chunk", [1, 7, 14, 100])
def test_chunked_ranges_equal_the_whole_file(data, chunk):
    path = data["shards"][0]
    n = native_loader.count_records(path)
    offsets = native_loader.chunk_offsets(path, chunk)
    assert offsets == jnative.chunk_offsets(path, chunk) and len(offsets) == -(-n // chunk)
    parts = [native_loader.parse_frame_file(path, start_offset=o, max_records=chunk, **FRAME_KW) for o in offsets]
    whole = native_loader.parse_frame_file(path, **FRAME_KW)
    for k in ("features", "num_frames", "labels"):
        np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]), whole[k])
    assert sum((p["video_id"] for p in parts), []) == whole["video_id"]


@pytest.mark.parametrize("chunk_records", [0, 5])
def test_parse_files_parallel_equals_jax(data, chunk_records):
    got = list(native_loader.parse_files_parallel(data["shards"], True, num_workers=2,
                                                  chunk_records=chunk_records, **FRAME_KW))
    want = list(jnative.parse_files_parallel(data["shards"], True, num_workers=2,
                                             chunk_records=chunk_records, **FRAME_KW))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_parse_equal(g, w)


@pytest.mark.parametrize("shuffle, shard", [(False, (0, 1)), (True, (0, 1)), (True, (1, 2))])
def test_native_batch_iterator_equals_jax(data, shuffle, shard):
    """Same seed, same batches: two epochs, the last one padded, chunked
    parses too."""
    kw = dict(frame_level=True, feature_sizes=SIZES, num_classes=V, max_frames=MAXF, num_epochs=2,
              shuffle=shuffle, seed=4, num_workers=2, shard_index=shard[0], num_shards=shard[1], chunk_records=6)
    got = list(pipeline.native_batch_iterator(str(data["dir"] / "shards" / "*"), 12, **kw))
    want = list(jpipeline.native_batch_iterator(str(data["dir"] / "shards" / "*"), 12, **kw))
    assert len(got) == len(want) > 1 and got[-1]["weights"].min() == 0
    for g, w in zip(got, want):
        _assert_parse_equal(g, w)


def test_native_batch_iterator_equals_the_python_reader_unshuffled(data):
    reader = YT8MFrameFeatureReader(V, SIZES, ("rgb", "audio"), MAXF)
    pattern = str(data["dir"] / "shards" / "*")
    want = list(pipeline.batch_iterator(reader, pattern, 16, num_epochs=1))
    got = list(pipeline.native_batch_iterator(pattern, 16, True, SIZES, num_classes=V, max_frames=MAXF))
    for g, w in zip(got, want):
        _assert_parse_equal(g, w)


@pytest.mark.parametrize("case", ["mixed_ids", "id_width_bytes", "large_values"])
def test_format_csv_is_byte_equal_to_jax_and_format_lines(case):
    rng = np.random.default_rng(0)
    if case == "large_values":
        vids = [b"v0", "v1"]
        vals = np.array([[1e12, -123456.75, 1e20, 0.5, -1e26], [1e30, 0.0, -0.0, 1e-7, 3.25]], np.float32)
    else:
        vids = ([b"a", b"longer_video_id_0123", "strid42", b"x" * 31] if case == "mixed_ids"
                else [b"y" * native_loader.ID_WIDTH, b"z" * (native_loader.ID_WIDTH - 1), b""])
        vals = (rng.random((len(vids), 5)) * 2 - 1).astype(np.float32)
    idxs = rng.integers(0, 4000, size=vals.shape).astype(np.int32)
    got = native_loader.format_csv(vids, vals, idxs)
    assert got == jnative.format_csv(vids, vals, idxs)
    assert got == "".join(format_lines(vids, vals, idxs)).encode() == "".join(jformat_lines(vids, vals, idxs)).encode()


def test_format_csv_rejects_what_it_cannot_format():
    with pytest.raises(ValueError, match="too large"):
        native_loader.format_csv([b"v0"], np.array([[1e38]], np.float32), np.array([[0]], np.int32))


def test_missing_file_raises():
    for fn in (native_loader.count_records, lambda p: native_loader.parse_frame_file(p, max_records=1),
               lambda p: native_loader.chunk_offsets(p, 4)):
        with pytest.raises(IOError):
            fn("/nonexistent/x.tfrecord")


def test_truncated_record_is_dropped_as_jax_drops_it(data, tmp_path):
    """A file cut inside its last record: both native parses return the
    whole records before it, and the Python reader raises."""
    path = str(tmp_path / "cut.tfrecord")
    blob = Path(data["frames"]).read_bytes()
    Path(path).write_bytes(blob[:-50])
    got = native_loader.parse_frame_file(path, **FRAME_KW)
    _assert_parse_equal(got, jnative.parse_frame_file(path, **FRAME_KW))
    assert len(got["video_id"]) == native_loader.count_records(path) - 1 == 10
    with pytest.raises(ValueError, match="truncated"):
        list(YT8MFrameFeatureReader(V, SIZES, ("rgb", "audio"), MAXF).read_file(path))


_BUILD = """
import sys
from pathlib import Path
from learnablepoolingmethods_torch.data import native_loader
native_loader.BUILD_DIR = Path(sys.argv[1])
print(native_loader.count_records(sys.argv[2]), native_loader.library_path().name)
"""


def test_processes_building_at_once_all_load(data, tmp_path):
    """Four processes build into one empty directory at once: each loads a
    whole library, and one file is left, named by the sources' hash."""
    build_dir = tmp_path / "host"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(build_dir), data["videos"]], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    names = {o[0].split()[1] for o in outs}
    assert {o[0].split()[0] for o in outs} == {"9"} and len(names) == 1
    assert sorted(f.name for f in build_dir.iterdir()) == sorted(names)


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """No fallback: a source that does not compile makes every entry point
    raise, naming g++'s error; is_available and load_error say so."""
    src = tmp_path / "native"
    shutil.copytree(native_loader.NATIVE_DIR, src)
    (src / "csv_formatter.cc").write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "NATIVE_DIR", src)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "host")
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_load_error", None)
    fixtures.write_video_level_fixture(str(tmp_path / "v.tfrecord"), 3, num_classes=V, rgb_size=8, audio_size=4)
    assert not native_loader.is_available()
    assert "g++ failed" in native_loader.load_error() and "csv_formatter.cc" in native_loader.load_error()
    with pytest.raises(RuntimeError, match="native loader unavailable: RuntimeError: g\\+\\+ failed"):
        next(pipeline.native_batch_iterator(str(tmp_path / "*.tfrecord"), 4, frame_level=False,
                                            feature_sizes=SIZES, num_classes=V))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_loader.format_csv([b"v"], np.zeros((1, 1), np.float32), np.zeros((1, 1), np.int32))
    assert not list((tmp_path / "host").glob("*.tmp"))


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 63, 64, 65, 129, 4096, 65_543, 345_601])
def test_numpy_crc32c_equals_google_crc32c(n):
    """The writers' CRC where google_crc32c is not installed (the card's
    machine) against its C code."""
    import google_crc32c

    from learnablepoolingmethods_torch.data import tfrecord_io

    data = np.random.default_rng(n).bytes(n)
    assert tfrecord_io._crc32c_numpy(data) == google_crc32c.value(data)
