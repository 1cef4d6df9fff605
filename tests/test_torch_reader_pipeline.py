"""Port parity: the reader pipeline of the training infrastructure
(paddle_tpu_torch/reader/pipeline.py, recordio.py with the native
codec, provider.py, ``batch`` over a checkpointable reader, and
dataset.common.convert) against paddle_tpu on the CPU.

- ErrorBudget and supervised(): the port's counterparts of
  tests/test_reader_faults.py (quarantine counts, ordered and unordered
  delivery, a crashed worker restarted with no sample lost, a hung
  source detected and, in raise mode, surfaced), each beside the JAX
  package's pipeline on the same faults: the same samples out.
- CheckpointableReader resumes exactly, across shards, and
  ``batch()``'s ``state_for`` seeks both packages' readers alike.
- recordio: files written by either package, with the native or the
  Python codec, are byte-identical and read back in the other.
- provider(): the same samples as the JAX package's.
- Every dataset's ``convert`` (each split's first 40 samples, the
  shards' bytes) writes what the JAX package's writes.
"""

import importlib
import pickle
import threading

import numpy as np
import pytest

import paddle_tpu.reader as jreader
import paddle_tpu_torch.reader as treader
from paddle_tpu.reader import recordio as jrio
from paddle_tpu.testing.faults import FaultPlan as JaxFaultPlan
from paddle_tpu_torch.reader import recordio as trio
from paddle_tpu_torch.testing.faults import FaultPlan
from paddle_tpu_torch.trainer.event import DataFaultEvent, FaultEvent
from paddle_tpu_torch.utils.stats import global_counters

PKGS = {"jax": jreader, "port": treader}

@pytest.fixture(autouse=True)
def _port_device_restored():
    """The port's process device back to the default (the card) after
    each test: a test here that inits the CPU must not leave it to the
    next file's tests."""
    yield
    from paddle_tpu_torch import config as tconfig
    tconfig.init(seed=0)



def counts(n):
    def reader():
        return iter(range(n))
    return reader


def _records(n=40, dim=6, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(n, dim).astype("float32")
    return [pickle.dumps((i, feats[i], int(i % 3))) for i in range(n)]


def _shard(path, rio, n=25, seed=0, chunk_bytes=128, corrupt_at=()):
    recs = _records(n, seed=seed)
    if corrupt_at:
        recs = list(FaultPlan(seed=seed).corrupt_records(recs, corrupt_at))
    rio.write_records(str(path), recs, max_chunk_bytes=chunk_bytes)
    return str(path)


@pytest.mark.parametrize("seed", [0, 5])
def test_corrupt_records_byte_equal_to_jax(seed):
    recs = _records(12, seed=seed)
    got = list(FaultPlan(seed=seed).corrupt_records(recs, [1, 4, 11]))
    assert got == list(JaxFaultPlan(seed=seed).corrupt_records(recs,
                                                               [1, 4, 11]))
    assert [i for i, (a, b) in enumerate(zip(got, recs)) if a != b] == \
        [1, 4, 11]
    assert all(got[i][0] == 0xFF for i in (1, 4, 11))


# ----------------------------------------------------------- ErrorBudget
def test_error_budget_counts_emits_once_and_raises():
    base = global_counters.value("pipeline/quarantined")
    events = []
    eb = treader.ErrorBudget(max_bad=1, on_event=events.append)
    for tag in "abc":
        eb.record(ValueError(tag), where=tag)
    assert eb.bad == 3 and eb.exhausted
    assert global_counters.value("pipeline/quarantined") == base + 3
    data = [e for e in events if isinstance(e, DataFaultEvent)]
    assert [e.kind for e in data] == ["data_budget"]
    assert isinstance(data[0], FaultEvent)
    eb = treader.ErrorBudget(max_bad=1, on_bad="raise")
    eb.record(ValueError("a"))
    with pytest.raises(treader.ErrorBudgetExceeded):
        eb.record(ValueError("b"))
    with pytest.raises(ValueError):
        treader.ErrorBudget(on_bad="explode")


# ------------------------------------------------------------ supervised
@pytest.mark.parametrize("order", [True, False])
def test_supervised_delivers_like_jax(order):
    got = {}
    for name, pkg in PKGS.items():
        eb = pkg.ErrorBudget(max_bad=10)
        sr = pkg.supervised(
            counts(60), mapper=FaultPlan().raising_mapper(
                lambda v: v * 2, [3, 11, 27]),
            num_workers=3, order=order, error_budget=eb)
        out = list(sr())
        got[name] = out if order else sorted(out)
        assert eb.bad == 3
    assert got["port"] == got["jax"]
    assert len(got["port"]) == 57


def test_crashed_worker_restarts_with_no_loss():
    events = []
    base = global_counters.value("pipeline/worker_restarts")
    sr = treader.supervised(
        counts(40), mapper=FaultPlan().crashing_mapper(lambda v: v * 10,
                                                       [7]),
        num_workers=2, on_event=events.append)
    assert sorted(sr()) == [v * 10 for v in range(40)]
    assert sr.restarts == 1
    assert global_counters.value("pipeline/worker_restarts") == base + 1
    assert "worker_restart" in [e.kind for e in events]
    sr = treader.supervised(
        counts(40), mapper=FaultPlan().crashing_mapper(lambda v: v,
                                                       range(6)),
        num_workers=1, max_restarts=2)
    with pytest.raises(RuntimeError, match="restart budget"):
        list(sr())


@pytest.mark.chaos(timeout=60)
def test_hung_source_detected_then_raised():
    events = []
    rdr = FaultPlan.hung_reader(counts(20), hang={10: 0.6})
    sr = treader.supervised(rdr, buffer_size=4, sample_timeout=0.15,
                            on_event=events.append)
    assert list(sr()) == list(range(20))
    assert sr.stalls >= 1
    assert "source_stall" in [e.kind for e in events]
    release = threading.Event()
    rdr = FaultPlan.hung_reader(counts(20), release={5: release})
    sr = treader.supervised(rdr, buffer_size=4, sample_timeout=0.1,
                            on_stall="raise", stall_limit=3)
    try:
        with pytest.raises(TimeoutError, match="stalled"):
            list(sr())
    finally:
        release.set()


def test_abandoned_pipeline_stops_its_threads():
    sr = treader.supervised(counts(10000), mapper=lambda v: v,
                            num_workers=3, buffer_size=4)
    g = sr()
    for _ in range(5):
        next(g)
    g.close()
    # the conftest leak check holds that no pt-data-* thread is left


# -------------------------------------------------- CheckpointableReader
def test_checkpointable_resume_across_shards_like_jax(tmp_path):
    paths = [_shard(tmp_path / f"s{i}", trio, n=10, seed=i,
                    chunk_bytes=96) for i in range(3)]
    full = [s[0] for s in treader.CheckpointableReader(paths)()]
    assert len(full) == 30
    for cut in (0, 7, 13, 29):
        states = {}
        for name, pkg in PKGS.items():
            cr = pkg.CheckpointableReader(paths)
            it = iter(cr())
            head = [next(it)[0] for _ in range(cut)]
            states[name] = cr.state()
            cr2 = pkg.CheckpointableReader(paths)
            cr2.set_state(states[name])
            tail = [s[0] for s in cr2()]
            assert head + tail == full, (name, cut)
        assert states["port"] == states["jax"]
    cr = treader.CheckpointableReader(paths)
    list(cr())
    assert cr.state() == {"epoch": 1, "shard": 0, "chunk": 0, "offset": 0}
    with pytest.raises(ValueError, match="out of range"):
        cr.set_state({"epoch": 0, "shard": 5, "chunk": 0, "offset": 0})


def test_corrupt_records_quarantined_and_batch_state_for(tmp_path):
    shard = _shard(tmp_path / "s0", trio, corrupt_at={2, 9, 17})
    eb = treader.ErrorBudget(max_bad=10)
    ids = [s[0] for s in treader.CheckpointableReader(
        shard, error_budget=eb, use_native=True)()]
    assert ids == [i for i in range(25) if i not in {2, 9, 17}]
    assert eb.bad == 3
    with pytest.raises(Exception):
        list(treader.CheckpointableReader(shard)())
    clean = _shard(tmp_path / "s1", trio)
    states = {}
    for name, pkg in PKGS.items():
        b = pkg.batch(pkg.CheckpointableReader(clean), 4)
        assert hasattr(b, "state_for")
        assert len(list(b())) == 7
        states[name] = b.state_for(2)
    assert states["port"] == states["jax"]
    cr = treader.CheckpointableReader(clean)
    cr.set_state(states["port"])
    assert [s[0] for s in cr()] == list(range(12, 25))


# --------------------------------------------------------------- recordio
def test_native_codec_builds_and_use_native_never_falls_back(monkeypatch):
    assert trio._native(strict=True) is not None
    monkeypatch.setattr(trio, "_lib", None)
    monkeypatch.setattr(trio, "_lib_error", "NativeCodecError: no build")
    with pytest.raises(trio.NativeCodecError):
        trio.write_records("unused", [b"x"], use_native=True)
    with pytest.raises(trio.NativeCodecError):
        trio.num_chunks("unused", use_native=True)


@pytest.mark.parametrize("writer", ["jax-native", "jax-python",
                                    "port-native", "port-python"])
def test_recordio_bytes_and_reads_across_packages(tmp_path, writer):
    recs = _records(60) + [b"", b"\x00" * 300]
    pkg, codec = writer.split("-")
    rio = {"jax": jrio, "port": trio}[pkg]
    path = str(tmp_path / "shard")
    rio.write_records(path, recs, max_chunk_bytes=256,
                      use_native=codec == "native")
    ref = str(tmp_path / "ref")
    jrio.write_records(ref, recs, max_chunk_bytes=256, use_native=False)
    with open(path, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()
    for reader_rio in (jrio, trio):
        for native in (True, False):
            n = reader_rio.num_chunks(path, use_native=native)
            got = [r for k in range(n) for r in reader_rio.read_chunk(
                path, k, use_native=native)]
            assert got == recs


def test_recordio_integrity_in_the_port(tmp_path):
    path = _shard(tmp_path / "s", trio, n=40, chunk_bytes=200)
    n = trio.num_chunks(path)
    raw = bytearray(open(path, "rb").read())
    raw[40] ^= 0xFF                      # inside chunk 0's payload
    open(path, "wb").write(bytes(raw))
    for native in (True, False):
        with pytest.raises(ValueError, match="crc"):
            trio.read_chunk(path, 0, use_native=native)
        before = trio.corrupt_chunks_skipped()
        assert trio.read_chunk(path, 0, use_native=native,
                               skip_corrupt=True) == []
        assert trio.corrupt_chunks_skipped() == before + 1
        assert trio.read_chunk(path, n - 1, use_native=native)
    with open(path, "ab") as f:          # a torn tail is end of file
        f.write(b"PTRC-garbage")
    assert trio.num_chunks(path, use_native=True) == n
    assert trio.num_chunks(path, use_native=False) == n


def test_recordio_creator_reads_convert_output(tmp_path):
    from paddle_tpu_torch.dataset import common
    samples = [(np.arange(3, dtype=np.float32) + i, i) for i in range(30)]
    paths = common.convert(str(tmp_path), lambda: iter(samples), 12, "t")
    assert [p.rsplit("/", 1)[1] for p in paths] == ["t-00000", "t-00001",
                                                    "t-00002"]
    got = list(treader.creator.recordio(paths)())
    assert [s[1] for s in got] == list(range(30))
    np.testing.assert_array_equal(got[7][0], samples[7][0])
    assert [s[1] for s in jreader.creator.recordio(paths)()] == \
        list(range(30))


# --------------------------------------------------------------- provider
def _provider_pair():
    import paddle_tpu as jpaddle
    import paddle_tpu_torch as tpaddle
    from paddle_tpu.reader import provider as jprov
    from paddle_tpu_torch.reader import provider as tprov

    def make(prov, paddle):
        @prov.provider(input_types=[paddle.data_type.dense_vector(4),
                                    paddle.data_type.integer_value(3)],
                       should_shuffle=False,
                       cache=prov.CacheType.CACHE_PASS_IN_MEM,
                       init_hook=lambda s, **kw: setattr(
                           s, "offset", kw.get("offset", 0)))
        def process(settings, filename):
            base = int(filename.rsplit("-", 1)[-1]) + settings.offset
            for i in range(3):
                yield np.full(4, base + i, np.float32), (base + i) % 3
        return process

    return (jprov, make(jprov, jpaddle)), (tprov, make(tprov, tpaddle))


def test_provider_yields_the_jax_samples(tmp_path):
    (jprov, jp), (tprov, tp) = _provider_pair()
    assert isinstance(tp, tprov.DataProvider)
    files = ["f-0", "f-10"]
    jr = jprov.provider_reader(jp, files, offset=5)
    tr = tprov.provider_reader(tp, files, offset=5)
    for _ in range(2):                    # the second pass is cached
        jout, tout = list(jr()), list(tr())
        assert len(tout) == 6
        for (ja, jb), (ta, tb) in zip(jout, tout):
            np.testing.assert_array_equal(ta, ja)
            assert tb == jb
    lst = tmp_path / "train.list"
    lst.write_text("f-0\nf-10\n")
    srcs = tprov.define_py_data_sources2(str(lst), None, module=__name__,
                                         obj=tp, args={"offset": 1})
    assert set(srcs) == {"train"} and len(list(srcs["train"]())) == 6


# ------------------------------------------------------- dataset.convert
CONVERTS = ["cifar", "conll05", "flowers", "imdb", "imikolov", "mnist",
            "movielens", "mq2007", "sentiment", "uci_housing", "voc2012",
            "wmt14"]


@pytest.mark.parametrize("name", CONVERTS)
def test_convert_writes_the_jax_shards(name, tmp_path, monkeypatch):
    """Each package's ``convert`` of the dataset, every split's reader
    cut to its first 40 samples (the full splits are up to 8192 images):
    the same shard files, byte for byte."""
    out = {}
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        common = importlib.import_module(f"{pkg}.dataset.common")
        real = common.convert

        def cut(path, reader, line_count, prefix, *a, _real=real, **kw):
            def first():
                for i, s in enumerate(reader()):
                    if i == 40:
                        return
                    yield s
            return _real(path, first, min(line_count, 16), prefix, *a,
                         **kw)

        monkeypatch.setattr(common, "convert", cut)
        d = tmp_path / pkg
        importlib.import_module(f"{pkg}.dataset.{name}").convert(str(d))
        out[pkg] = {p.name: p.read_bytes() for p in d.iterdir()}
    assert out["paddle_tpu_torch"].keys() == out["paddle_tpu"].keys()
    assert len(out["paddle_tpu"]) >= 3
    for k, v in out["paddle_tpu"].items():
        assert out["paddle_tpu_torch"][k] == v, k
