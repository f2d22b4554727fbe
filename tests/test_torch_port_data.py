"""Port parity for the data layer, against the JAX package on the CPU.

- The loaders (records, sampling, pipeline, the host cache): the same
  records, configuration and seed give identical batches (frames, labels,
  record_index) in both packages, for synthetic frames and for a tiny
  generated miniact set read through the native decoder and through PIL.
- The augmentation: ``augment_train`` with the JAX package's draws
  replayed from its key, ``augment_eval``, ``augment_eval_views`` in every
  ``eval_crops`` mode and ``glance_downsample``, within atol 1e-4 on the
  normalised float32 values (measured: under 1e-6). 256 -> 224 with a crop
  of 256 exercises JAX's antialiased resampler.
- The batch prep, train and eval (multi-clip, views), against JAX's with
  the ``frames_flat`` padding removed, within the same tolerance.
"""

import dataclasses
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adafocus_torch import config as tconfig
from adafocus_torch.cli import common as tcommon
from adafocus_torch.data import cache as tcache
from adafocus_torch.data import miniact as tminiact
from adafocus_torch.data import native as tnative
from adafocus_torch.data import pipeline as tpipe
from adafocus_torch.data import records as trecords
from adafocus_torch.data import transforms as tt
from adafocus_tpu import config as jconfig
from adafocus_tpu.cli import common as jcommon
from adafocus_tpu.data import cache as jcache
from adafocus_tpu.data import native as jnative
from adafocus_tpu.data import pipeline as jpipe
from adafocus_tpu.data import records as jrecords
from adafocus_tpu.data import transforms as jt

ATOL = 1e-4
# the tiny profile of benchmarks/miniact_harness.py:64-83
MINIACT_GEN = dict(classes=4, train_per_class=6, val_per_class=3, frames=4, canvas=64)
TINY_MODEL = ["model.num_classes=4", "model.num_frames=4", "model.image_size=32",
              "model.glance_size=16", "model.patch_size=16", "model.action_dim=4",
              "model.hidden_dim=16", "model.policy_hidden=16", "model.dtype=float32",
              "loader.batch_size=4", "loader.canvas_size=40"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module (and the modules that import
    this fixture): the suite runs several workers a machine, and each
    worker's torch would otherwise start a thread a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_miniact(root: str) -> None:
    """The tiny miniact set (benchmarks/miniact_harness.py's --tiny
    generation arguments) written by the port's copy of the generator."""
    g = MINIACT_GEN
    cfg = tminiact.MiniactConfig(
        num_classes=g["classes"], train_per_class=g["train_per_class"],
        val_per_class=g["val_per_class"], num_frames=g["frames"], canvas=g["canvas"],
        tile=max(16, round(g["canvas"] * 72 / 256 / 8) * 8),
        min_present=max(1, (g["frames"] * 10) // 16),
        max_drift=max(8, g["canvas"] * 50 // 256))
    tminiact.generate(root, cfg, log=lambda msg: None)


@pytest.fixture(scope="module")
def miniact_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("miniact"))
    make_miniact(root)
    return root


def jax_draws(key, b: int, canvas: int, cfg) -> tt.AugmentDraws:
    """The draws of ``adafocus_tpu.data.transforms.augment_train(videos,
    key, cfg)``: per video, the key split three ways (pair, offset, flip)."""
    n_pairs = len(jt._crop_pairs(canvas, cfg))
    n_offsets = len(jt._offset_grid(cfg))
    rows = []
    for k in jax.random.split(key, b):
        kp, ko, kf = jax.random.split(k, 3)
        rows.append((int(jax.random.randint(kp, (), 0, n_pairs)),
                     int(jax.random.randint(ko, (), 0, n_offsets)),
                     bool(jax.random.bernoulli(kf))))
    a = np.array(rows)
    return tt.AugmentDraws(torch.from_numpy(a[:, 0]), torch.from_numpy(a[:, 1]),
                           torch.from_numpy(a[:, 2].astype(bool)))


def _videos(b, t, canvas, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (b, t, canvas, canvas, 3)
                                               ).astype(np.uint8)


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

def _clear_memos(root: str) -> None:
    """Remove the caches' decoded memos: the memo's name does not say which
    decoder wrote it (in either package), so a test switching decoders
    starts without one."""
    frames = os.path.join(root, "frames")
    for name in os.listdir(frames):
        if name.startswith(".decoded_"):
            os.remove(os.path.join(frames, name))


# seconds to wait for the JAX package's native library to become loadable
NATIVE_WAIT_S = 120.0


def wait_loadable(native, timeout_s: float = NATIVE_WAIT_S, poll_s: float = 0.5) -> bool:
    """``native.available()``, retried until the library loads or
    ``timeout_s`` passes. The JAX package builds ``native/libframeloader.so``
    with an in-place ``make`` (adafocus_tpu/data/native.py:32-43): while
    another process (a worker running tests/test_native.py) links it, the
    file exists but is partial, ``ctypes.CDLL`` fails, and ``load_library``
    memoises the failure (``_tried``) for the whole process. So the memo is
    reset (under the module's lock) before each retry."""
    deadline = time.monotonic() + timeout_s
    while not native.available():
        if time.monotonic() >= deadline:
            return False
        time.sleep(poll_s)
        with native._lock:
            native._tried = False
    return True


class _FlakyNative:
    """A stand-in for adafocus_tpu/data/native.py whose library fails to
    load ``failures`` times (memoised, as the real module memoises it), then
    loads."""

    def __init__(self, failures: int):
        self._lock = threading.Lock()
        self._tried = False
        self.failures = failures
        self.attempts = 0
        self._lib = None

    def available(self) -> bool:
        with self._lock:
            if self._lib is None and not self._tried:
                self._tried = True
                self.attempts += 1
                if self.attempts > self.failures:
                    self._lib = object()
            return self._lib is not None


def test_wait_loadable_retries_a_memoised_failure():
    flaky = _FlakyNative(failures=2)
    assert wait_loadable(flaky, timeout_s=10.0, poll_s=0.01)
    assert flaky.attempts == 3 and flaky.available()
    never = _FlakyNative(failures=10**9)
    t0 = time.monotonic()
    assert not wait_loadable(never, timeout_s=0.2, poll_s=0.01)
    assert 0.2 <= time.monotonic() - t0 < 5.0 and never.attempts > 2


def _assert_same_batches(jloader, tloader, epochs=(0, 1)):
    n = 0
    for epoch in epochs:
        jloader.set_epoch(epoch)
        tloader.set_epoch(epoch)
        jb, tb = list(jloader), list(tloader)
        assert len(jb) == len(tb) == len(jloader) == len(tloader)
        for a, b in zip(jb, tb):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
            n += 1
    assert n > 0


@pytest.mark.parametrize("source", ["synthetic", "native", "pil"])
@pytest.mark.parametrize("mode", ["train", "val"])
@pytest.mark.parametrize("cache", ["", "host"])
def test_loader_batches_identical(miniact_root, source, mode, cache):
    """The same records and seed: bit-identical frames, labels (multi-label
    lists, shuffled in training) and record_index in both packages, over two
    epochs."""
    fields = dict(num_segments=3, canvas_size=40, batch_size=4, mode=mode,
                  num_workers=2, cache=cache, seed=11, multi_label=True,
                  drop_last=mode == "train")
    if source == "synthetic":
        jrecs = [jrecords.VideoRecord(f"v{i}", 7, (i % 3, (i + 1) % 3, -1) if i % 2
                                      else (i % 3, -1, -1)) for i in range(10)]
        trecs = [trecords.VideoRecord(r.path, r.num_frames, r.labels) for r in jrecs]
        jsrc, tsrc = jpipe.SyntheticVideoSource(), tpipe.SyntheticVideoSource()
    else:
        split = "train_split.txt" if mode == "train" else "val_split.txt"
        jrecs = jrecords.parse_list_file(os.path.join(miniact_root, split), "miniact")
        trecs = trecords.parse_list_file(os.path.join(miniact_root, split), "miniact")
        assert [dataclasses.astuple(r) for r in jrecs] == \
            [dataclasses.astuple(r) for r in trecs]
        frames = os.path.join(miniact_root, "frames")
        _clear_memos(miniact_root)
        native = source == "native"
        if native:
            assert tnative.available(), tnative.describe()
            assert wait_loadable(jnative)
        jsrc = jpipe.FrameFolderSource(frames, use_native=native)
        tsrc = tpipe.FrameFolderSource(frames, use_native=native)
        assert (tsrc._native is not None) == native
    jl = jpipe.VideoLoader(jrecs, jsrc, jpipe.LoaderConfig(**fields))
    tl = tpipe.VideoLoader(trecs, tsrc, tpipe.LoaderConfig(**fields))
    if cache:
        jl, tl = jcache.maybe_cache(jl, cache), tcache.maybe_cache(tl, cache)
        assert isinstance(tl, tcache.CachedVideoLoader)
    _assert_same_batches(jl, tl)


@pytest.mark.parametrize("canvas", [1, 5, 7, 40])
def test_synthetic_frames_match_jax(canvas):
    # the port reads the generator's raw outputs as bytes; at canvases whose
    # frame is and is not a whole number of 8-byte outputs
    jrec, trec = jrecords.VideoRecord("v3", 5, (1, -1, -1)), trecords.VideoRecord("v3", 5, (1, -1, -1))
    for index in (1, 2, 5):
        got = tpipe.SyntheticVideoSource().load_frame(trec, index, canvas)
        want = jpipe.SyntheticVideoSource().load_frame(jrec, index, canvas)
        assert got.shape == want.shape == (canvas, canvas, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_device_cache_of_a_source_without_directory():
    """A source with no directory (nothing to memoize) fills a device cache,
    here on the CPU, video by video: the same batches as the JAX package's
    host cache."""
    fields = dict(num_segments=3, canvas_size=40, batch_size=4, mode="train",
                  num_workers=2, seed=11, drop_last=True)
    jrecs = [jrecords.VideoRecord(f"v{i}", 7, (i % 3, -1, -1)) for i in range(10)]
    trecs = [trecords.VideoRecord(r.path, r.num_frames, r.labels) for r in jrecs]
    jl = jcache.maybe_cache(jpipe.VideoLoader(jrecs, jpipe.SyntheticVideoSource(),
                                              jpipe.LoaderConfig(**fields)), "host")
    tl = tcache.maybe_cache(tpipe.VideoLoader(trecs, tpipe.SyntheticVideoSource(),
                                              tpipe.LoaderConfig(**fields)),
                            "device", torch.device("cpu"))
    assert tl._memo_path() == ""
    tl.fill()
    assert isinstance(tl._frames, torch.Tensor) and tl.nbytes == 10 * 7 * 40 * 40 * 3
    _assert_same_batches(jl, tl)


def test_cache_matches_stream_and_memo(miniact_root, tmp_path):
    """The host cache serves what the streaming loader serves, its memo
    round-trips, and ``fill`` reports the bytes it holds."""
    fields = dict(num_segments=3, canvas_size=40, batch_size=4, mode="train",
                  num_workers=2, seed=5)
    recs = trecords.parse_list_file(os.path.join(miniact_root, "train_split.txt"), "miniact")
    _clear_memos(miniact_root)
    src = tpipe.FrameFolderSource(os.path.join(miniact_root, "frames"))
    stream = tpipe.VideoLoader(recs, src, tpipe.LoaderConfig(**fields))
    cached = tcache.maybe_cache(tpipe.VideoLoader(recs, src, tpipe.LoaderConfig(**fields)),
                                "host")
    assert cached.nbytes == 0
    cached.fill()
    assert cached.nbytes == len(recs) * 4 * 40 * 40 * 3
    assert os.path.exists(cached._memo_path())
    _assert_same_batches(stream, cached)
    again = tcache.maybe_cache(tpipe.VideoLoader(recs, src, tpipe.LoaderConfig(**fields)),
                               "host")
    np.testing.assert_array_equal(again._load_memoized(), cached._frames)
    # the device mode on the CPU: tensors, the same values
    on_cpu = tcache.maybe_cache(tpipe.VideoLoader(recs, src, tpipe.LoaderConfig(**fields)),
                                "device", torch.device("cpu"))
    cached.set_epoch(0)
    for a, b in zip(cached, on_cpu):
        assert isinstance(b["frames"], torch.Tensor)
        np.testing.assert_array_equal(a["frames"], b["frames"].numpy())
    with pytest.raises(ValueError):
        tcache.maybe_cache(stream, "device")


def test_native_builds_outside_the_source_tree():
    assert tnative.available(), tnative.describe()
    path = tnative.library_path()
    assert path.startswith(tnative.BUILD_DIR) and os.path.exists(path)
    assert "native libjpeg" in tnative.describe()


# ---------------------------------------------------------------------------
# augmentation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("canvas,size,b", [(40, 32, 6), (256, 224, 3)])
@pytest.mark.parametrize("seed", [0, 1])
def test_augment_train_matches_jax(canvas, size, b, seed):
    videos = _videos(b, 2, canvas, seed)
    jcfg, tcfg = jt.AugmentConfig(input_size=size), tt.AugmentConfig(input_size=size)
    key = jax.random.key(seed)
    want = np.asarray(jt.augment_train(jnp.asarray(videos), key, jcfg))
    draws = jax_draws(key, b, canvas, jcfg)
    got = tt.augment_train(torch.from_numpy(videos), None, tcfg, draws).numpy()
    assert got.shape == want.shape == (b, 2, size, size, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_augment_train_draws_from_generator():
    """Drawn from a generator: the same generator state gives the same
    batch, every draw in range, and the crop of 256 (pair 0) present."""
    cfg = tt.AugmentConfig()
    videos = torch.from_numpy(_videos(64, 1, 256))
    d = tt.draw_augment(64, 256, cfg, torch.Generator().manual_seed(3), torch.device("cpu"))
    assert 0 <= int(d.pair.min()) and int(d.pair.max()) < len(tt._crop_pairs(256, cfg))
    assert 0 <= int(d.offset.min()) and int(d.offset.max()) < len(tt._offset_grid(cfg))
    assert 0 < int(d.flip.sum()) < 64
    a = tt.augment_train(videos[:4], torch.Generator().manual_seed(3), cfg)
    b = tt.augment_train(videos[:4], torch.Generator().manual_seed(3), cfg)
    assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["center", "oversample", "full_res"])
@pytest.mark.parametrize("canvas,size", [(40, 32), (256, 224)])
def test_augment_eval_views_match_jax(mode, canvas, size):
    videos = _videos(2, 2, canvas, 5)
    jcfg = jt.AugmentConfig(input_size=size, eval_crops=mode)
    tcfg = tt.AugmentConfig(input_size=size, eval_crops=mode)
    assert tt.num_eval_views(tcfg) == jt.num_eval_views(jcfg)
    want = np.asarray(jt.augment_eval_views(jnp.asarray(videos), jcfg))
    got = tt.augment_eval_views(torch.from_numpy(videos), tcfg).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(tt.augment_eval(torch.from_numpy(videos), tcfg).numpy(),
                               np.asarray(jt.augment_eval(jnp.asarray(videos), jcfg)),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("s_in,s_out", [(32, 16), (224, 112), (224, 224), (40, 16)])
def test_glance_downsample_matches_jax(s_in, s_out):
    x = np.random.RandomState(1).randn(2, 3, s_in, s_in, 3).astype(np.float32)
    want = np.asarray(jt.glance_downsample(jnp.asarray(x), s_out))
    got = tt.glance_downsample(torch.from_numpy(x), s_out)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    if s_in == s_out:
        assert torch.equal(got, torch.from_numpy(x))


def test_resample_weights_antialias():
    """A crop of 256 resampled to 224 widens the triangle to 256/224 input
    pixels; rows sum to 1 inside the input; a sample point outside it gets
    no weight."""
    inv = 256 / 224
    w = tt.resample_weights(256, 224, torch.tensor([inv]), torch.zeros(1))[0].double()
    sample = (np.arange(224) + 0.5) * inv - 0.5
    tri = np.maximum(0.0, 1.0 - np.abs(sample[:, None] - np.arange(256)[None]) / inv)
    # float32 sample points: one ulp at 256 is 1.5e-5
    np.testing.assert_allclose(w.numpy(), tri / tri.sum(1, keepdims=True), atol=3e-5)
    assert int((w > 0).sum(1).max()) == 3    # bilinear would touch 2
    w = tt.resample_weights(40, 32, torch.tensor([1.0]), torch.tensor([-20.0]))[0]
    assert torch.equal(w[-4:], torch.zeros(4, 40))


# ---------------------------------------------------------------------------
# batch prep
# ---------------------------------------------------------------------------

def _unpad(frames_flat, s):
    f = np.asarray(frames_flat)
    return f[..., : s * 3].reshape(f.shape[:3] + (s, 3))


@pytest.mark.parametrize("case", ["train", "eval", "eval_twice", "eval_views"])
def test_batch_prep_matches_jax(case):
    over = list(TINY_MODEL) + ["run.platform=cpu"]
    if case == "eval_twice":
        over.append("loader.twice_sample=true")
    if case == "eval_views":
        over.append("augment.eval_crops=oversample")
    jcfg, tcfg = jconfig.load_config(None, over), tconfig.load_config(None, over)
    train = case == "train"
    t = 8 if case == "eval_twice" else 4
    raw = {"frames": _videos(4, t, 40, 9),
           "labels": np.array([[0, 2, -1], [1, -1, -1], [3, 1, 0], [2, -1, -1]], np.int32),
           "record_index": np.arange(4, dtype=np.int32)}
    key = jax.random.key(4)
    jbatch, jlabels, jk = jcommon.make_batch_prep(jcfg, train)(dict(raw), key)
    draws = jax_draws(jax.random.split(key)[0], 4, 40, jcfg.augment) if train else None
    prep = tcommon.make_batch_prep(tcfg, train, torch.device("cpu"))
    tbatch, tlabels, tk = prep(dict(raw), None, draws)
    assert tk == jk == {"train": 1, "eval": 1, "eval_twice": 2, "eval_views": 10}[case]
    np.testing.assert_array_equal(tlabels, jlabels)
    np.testing.assert_array_equal(tbatch["labels"].numpy(), np.asarray(jbatch["labels"]))
    want = _unpad(jbatch["frames_flat"], 32)
    assert tuple(tbatch["frames"].shape) == want.shape
    assert tbatch["frames"].dtype == torch.float32
    # channels-last frames in their natural layout, as the backbones and the
    # patch kernel read them
    assert tbatch["frames"].is_contiguous() and tbatch["frames_small"].is_contiguous()
    np.testing.assert_allclose(tbatch["frames"].numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(tbatch["frames_small"].numpy(),
                               np.asarray(jbatch["frames_small"]), rtol=0, atol=ATOL)
    assert prep.host_frame_bytes == raw["frames"].nbytes


# ---------------------------------------------------------------------------
# prefetch
# ---------------------------------------------------------------------------

def test_prefetch_order_errors_and_early_stop():
    """Results in order; a worker's exception reaches the consumer; a
    consumer that stops early releases the worker thread."""
    import threading

    from adafocus_torch.data.prefetch import prefetch_to_device

    assert list(prefetch_to_device(range(7), lambda raw, i: (raw, i * 10))) == \
        [(k, 10 * k) for k in range(7)]

    def failing():
        yield 0
        yield 1
        raise OSError("frame 2 is corrupt")

    got = []
    with pytest.raises(OSError, match="frame 2"):
        for item in prefetch_to_device(failing(), lambda raw, i: raw):
            got.append(item)
    assert got == [0, 1]
    threads = threading.active_count()
    it = prefetch_to_device(range(1000), lambda raw, i: raw, depth=2)
    assert next(it) == 0
    it.close()
    assert threading.active_count() == threads
