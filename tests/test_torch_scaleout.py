"""PyTorch port, slice 17: the scaleout control plane against the JAX
package.

Every test of tests/test_scaleout.py and the two `GlovePerformer` tests of
tests/test_w2v_bridge.py, run on the port; then the performers and the
aggregators held against the JAX package's on the same inputs, the
aliasing rules of the port's performers, the TCP wire between the two
packages and a ``work_dir`` shared by both.  Models run on the CPU
(``device="cpu"``).

Tolerances (float32): a `NetworkPerformer` job and a whole 1-worker
simulate atol 1e-5 on the published parameters (the port's `fit_batch`
parity tests hold three Adam steps to 1e-5); Word2Vec (HS) and GloVe
deltas atol 1e-5 (tests/test_torch_nlp.py's ATOL); the aggregators and
the wire bitwise.

Timing: no test sleeps for a fixed time and then asserts.  Heartbeats are
made stale by moving their timestamps, the reaper's run waits on its
master's deadline, and every run carries its own time limit (a simulate
or a master's ``timeout``, a thread's join), so a test on a loaded
machine fails by its limit instead of hanging.
"""

import collections
import io
import pickle
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import scaleout as jso
from deeplearning4j_tpu.scaleout import tracker_server as jts
from deeplearning4j_tpu_torch import scaleout as tso
from deeplearning4j_tpu_torch.models import (
    MultiLayerNetwork,
    params_from_numpy,
)
from deeplearning4j_tpu_torch.nn import conf as tconf
from deeplearning4j_tpu_torch.scaleout import (
    DeltaSumAggregator,
    DistributedRunner,
    GlovePerformer,
    HogwildWorkRouter,
    Job,
    JobIterator,
    Master,
    NetworkPerformer,
    ParameterAveragingAggregator,
    RemoteStateTracker,
    StateTracker,
    StateTrackerServer,
    Word2VecPerformer,
    Worker,
    WorkerPerformer,
)
from deeplearning4j_tpu_torch.scaleout import tracker_server as tts
from deeplearning4j_tpu_torch.scaleout.performers import host_params
from deeplearning4j_tpu_torch.scaleout.runner import MODEL_KEY
from test_torch_threads import torch_two_threads  # noqa: F401 — autouse

CPU = {"device": "cpu"}
ATOL = 1e-5
RUN_S = 30.0          # every simulate / master run's own time limit


class EchoPerformer(WorkerPerformer):
    """Test fake (reference TestPerformer): result = work * 2."""

    def __init__(self):
        self.last_state = None

    def perform(self, job):
        job.result = np.asarray(job.work) * 2
        job.done = True

    def update(self, state):
        self.last_state = state


def _tiny_net_json(updater="adam"):
    """tests/test_scaleout.py's net: Dense 4-8, softmax 8-3, seed 7."""
    conf = tconf.MultiLayerConfiguration(
        conf=tconf.NeuralNetConfiguration(learning_rate=0.01,
                                          updater=updater, seed=7),
        layers=(tconf.DenseLayerConf(n_in=4, n_out=8),
                tconf.OutputLayerConf(n_in=8, n_out=3)))
    return conf.to_json()


def _numpy_tree(seed=0):
    """An initial model for `_tiny_net_json` as a host numpy tree."""
    rng = np.random.default_rng(seed)
    return [{"W": rng.standard_normal((4, 8)).astype(np.float32) * 0.5,
             "b": rng.standard_normal(8).astype(np.float32) * 0.1},
            {"W": rng.standard_normal((8, 3)).astype(np.float32) * 0.5,
             "b": rng.standard_normal(3).astype(np.float32) * 0.1}]


def _batch(seed, n=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _stale(tracker, worker_id, by=100.0):
    """Age a worker's heartbeat by `by` seconds (no sleeping)."""
    with tracker._lock:
        tracker._heartbeats[worker_id] -= by


# ---------------------------------------------------------------------------
# tests/test_scaleout.py, on the port


class TestStateTracker:
    def test_job_queue_and_clear(self):
        t = StateTracker()
        t.add_worker("w0")
        t.enqueue_job(Job(work=1, job_id=0))
        job = t.request_job("w0")
        assert job.work == 1
        assert t.request_job("w0") is None  # AlreadyWorking
        t.clear_job("w0")
        assert t.current_jobs() == []

    def test_reap_requeues_orphaned_job(self):
        t = StateTracker()
        t.add_worker("dead")
        t.enqueue_job(Job(work="x", job_id=0))
        t.request_job("dead")
        assert t.pending_jobs() == 0
        _stale(t, "dead")
        stale = t.reap_stale(timeout=10.0)
        assert stale == ["dead"]
        # orphaned job back at the FRONT of the queue
        t.enqueue_job(Job(work="y", job_id=1))
        assert t.pending_jobs() == 2
        t.add_worker("alive")
        assert t.request_job("alive").work == "x"

    def test_heartbeat_keeps_worker_alive(self):
        t = StateTracker()
        t.add_worker("w")
        t.add_worker("silent")
        _stale(t, "w")
        _stale(t, "silent")
        t.heartbeat("w")
        assert t.reap_stale(timeout=50.0) == ["silent"]
        assert t.workers() == ["w"]

    def test_work_persistence_roundtrip(self, tmp_path):
        t = StateTracker(work_dir=str(tmp_path))
        t.enqueue_job(Job(work={"a": 1}, job_id=7))
        assert t.saved_work() == [7]
        assert t.load_saved_work(7) == {"a": 1}
        t.add_worker("w")
        t.request_job("w")
        t.clear_job("w")
        assert t.saved_work() == []  # cleared on completion


class TestTrackerServer:
    def test_rejects_pickle_gadget(self):
        """A frame whose pickle references a non-allowlisted callable is
        rejected before any code runs."""
        class Evil:
            def __reduce__(self):
                import os
                return (os.system, ("echo pwned",))

        payload = pickle.dumps(Evil())
        with pytest.raises(pickle.UnpicklingError):
            tts._RestrictedUnpickler(io.BytesIO(payload)).load()
        # a torch tensor is not on the allowlist either
        with pytest.raises(pickle.UnpicklingError):
            tts._RestrictedUnpickler(io.BytesIO(
                pickle.dumps(torch.ones(2)))).load()
        # benign control traffic still decodes
        ok = pickle.dumps(("workers", (), {"arrays": np.ones(2)}))
        method, args, kwargs = tts._RestrictedUnpickler(
            io.BytesIO(ok)).load()
        assert method == "workers"
        np.testing.assert_array_equal(kwargs["arrays"], np.ones(2))

    def test_allowlist_is_jax_s_with_the_port_s_classes(self):
        port_names = {("deeplearning4j_tpu_torch.scaleout.api", "Job"),
                      ("deeplearning4j_tpu_torch.datasets.dataset",
                       "DataSet")}
        jax_names = {("deeplearning4j_tpu.scaleout.api", "Job"),
                     ("deeplearning4j_tpu.datasets.dataset", "DataSet")}
        assert tts._SAFE_GLOBALS - port_names == \
            jts._SAFE_GLOBALS - jax_names
        assert port_names <= tts._SAFE_GLOBALS
        assert tts._ALLOWED == jts._ALLOWED
        assert tts._MAX_FRAME == jts._MAX_FRAME

    def test_hmac_secret_rejects_unauthenticated_client(self):
        server = StateTrackerServer(secret="s3cret").start()
        try:
            host, port = server.address
            bad = RemoteStateTracker(host, port, timeout=5.0)
            with pytest.raises((RuntimeError, ConnectionError, OSError)):
                bad.workers()
            bad.close()
            good = RemoteStateTracker(host, port, secret="s3cret")
            good.add_worker("w0")
            assert good.workers() == ["w0"]
            good.close()
        finally:
            server.stop()

    def test_remote_tracker_proxies_full_surface(self):
        server = StateTrackerServer().start()
        try:
            host, port = server.address
            remote = RemoteStateTracker(host, port)
            remote.add_worker("w0")
            assert remote.workers() == ["w0"]
            remote.enqueue_job(Job(work=np.arange(3), job_id=0))
            job = remote.request_job("w0")
            np.testing.assert_array_equal(job.work, np.arange(3))
            remote.add_update("w0", {"p": np.ones(2)})
            (wid, upd), = remote.updates()
            assert wid == "w0"
            np.testing.assert_array_equal(upd["p"], np.ones(2))
            remote.set_global("model", 42)
            assert remote.get_global("model") == 42
            assert remote.increment("rounds") == 1
            remote.finish()
            assert remote.is_done()
            remote.close()
        finally:
            server.stop()

    def test_remote_tracker_rejects_unknown_method(self):
        server = StateTrackerServer().start()
        try:
            host, port = server.address
            remote = RemoteStateTracker(host, port)
            with pytest.raises(AttributeError):
                remote.not_a_method()
            remote.close()
        finally:
            server.stop()

    def test_remote_error_is_raised_not_swallowed(self):
        server = StateTrackerServer().start()
        try:
            remote = RemoteStateTracker(*server.address)
            with pytest.raises(RuntimeError, match="tracker error"):
                remote.load_saved_work(3)      # no work_dir: an error
            assert remote.workers() == []      # the connection lives on
            remote.close()
        finally:
            server.stop()

    def test_tracker_frame_length_cap(self):
        """A peer claiming an absurd frame length is dropped before the
        server buffers it."""
        server = StateTrackerServer().start()
        try:
            host, port = server.address
            with socket.create_connection((host, port), timeout=10) as s:
                s.sendall(struct.pack(">I", tts._MAX_FRAME + 1))
                s.settimeout(10)
                assert s.recv(1) == b""
        finally:
            server.stop()


class TestSimulatedCluster:
    def test_iterative_reduce_echo(self):
        runner = DistributedRunner()
        result = runner.simulate(
            payloads=[np.full(2, i, np.float32) for i in range(6)],
            performer_factory=EchoPerformer,
            aggregator=ParameterAveragingAggregator(),
            n_workers=3, timeout=RUN_S)
        assert result.shape == (2,)
        assert runner.tracker.counter("updates") == 6

    def test_hogwild_router_processes_everything(self):
        runner = DistributedRunner()
        seen = []

        class Recorder(EchoPerformer):
            def perform(self, job):
                super().perform(job)
                seen.append(float(np.asarray(job.work)[0]))

        result = runner.simulate(
            payloads=[np.full(1, i, np.float32) for i in range(8)],
            performer_factory=Recorder,
            aggregator=DeltaSumAggregator(),
            router=HogwildWorkRouter(),
            apply_aggregate=lambda model, agg_val: (
                agg_val if model is None else model + agg_val),
            n_workers=2, timeout=RUN_S)
        assert sorted(seen) == [float(i) for i in range(8)]
        # sum of all deltas = 2 * sum(0..7) = 56
        assert float(result[0]) == 56.0

    def test_many_workers_lose_no_update(self):
        """More worker threads than cores, a short switch interval: every
        job is performed once and its update absorbed once."""
        import sys

        prev = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            runner = DistributedRunner()
            result = runner.simulate(
                payloads=[np.full(1, i, np.float64) for i in range(200)],
                performer_factory=EchoPerformer,
                aggregator=DeltaSumAggregator(),
                router=HogwildWorkRouter(depth=3),
                apply_aggregate=lambda model, agg_val: (
                    agg_val if model is None else model + agg_val),
                n_workers=12, timeout=RUN_S)
        finally:
            sys.setswitchinterval(prev)
        assert runner.tracker.counter("updates") == 200
        assert float(result[0]) == 2.0 * sum(range(200))

    def test_reaper_removes_dead_worker_and_work_completes(self):
        tracker = StateTracker()
        # "doomed" registers, grabs a job, and dies holding it: no
        # heartbeat, no result; the master reaps it once its heartbeat is
        # a second old and re-serves the orphaned job to the live worker
        tracker.add_worker("doomed")
        tracker.enqueue_job(Job(work=np.full(1, 99.0), job_id=100))
        assert tracker.request_job("doomed") is not None
        live = Worker(tracker, EchoPerformer(),
                      heartbeat_interval=0.02).start()
        try:
            master = Master(tracker,
                            JobIterator([np.ones(1) * i for i in range(4)]),
                            ParameterAveragingAggregator(),
                            heartbeat_timeout=1.0)
            assert master.run(timeout=RUN_S) is not None
        finally:
            live.stop(timeout=RUN_S)
        assert master.reaped == ["doomed"]
        assert tracker.counter("updates") == 5
        assert live.performed == 5


class TestNetworkPerformer:
    def test_shared_state_survives_in_place_training(self):
        """The broadcast tree handed to two replicas stays bitwise as it
        was after both step from it, and each replica's published result
        does not move at its next fit_batch."""
        conf_json = _tiny_net_json()
        a = NetworkPerformer(conf_json, **CPU)
        b = NetworkPerformer(conf_json, **CPU)
        shared = _numpy_tree()
        before = [{k: v.copy() for k, v in p.items()} for p in shared]
        a.update(shared)
        b.update(shared)
        job_a, job_b = Job(work=_batch(0)), Job(work=_batch(1))
        a.perform(job_a)
        b.perform(job_b)
        for got, want in zip(shared, before):
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        published = [{k: v.copy() for k, v in p.items()}
                     for p in job_a.result]
        a.perform(Job(work=_batch(2)))
        for got, want in zip(job_a.result, published):
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        # the results are host float32 numpy with JAX's keys, and moved
        for res in (job_a.result, job_b.result):
            assert [sorted(p) for p in res] == [["W", "b"], ["W", "b"]]
            for p, s in zip(res, shared):
                for k in p:
                    assert isinstance(p[k], np.ndarray)
                    assert p[k].dtype == np.float32
                    assert not np.array_equal(p[k], s[k])

    def test_performers_without_a_device_refuse_the_cpu(self, monkeypatch):
        from deeplearning4j_tpu_torch.nlp import Glove, Word2Vec

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            NetworkPerformer(_tiny_net_json())
        # the embedding performers wrap a model, which takes the device
        for cls in (Word2Vec, Glove):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cls(vector_length=8)
        assert NetworkPerformer(_tiny_net_json(), **CPU).net.device.type \
            == "cpu"

    def test_param_averaging_trains_iris(self):
        from deeplearning4j_tpu_torch.datasets.fetchers import iris_dataset

        ds = iris_dataset()
        conf_json = _tiny_net_json()
        seed_net = MultiLayerNetwork.from_json(conf_json, **CPU)
        batches = [(ds.features[i::4], ds.labels[i::4]) for i in range(4)]
        payloads = batches * 80  # ~80 passes over the data

        runner = DistributedRunner()
        final = runner.simulate(
            payloads=payloads,
            performer_factory=lambda: NetworkPerformer(conf_json, **CPU),
            aggregator=ParameterAveragingAggregator(),
            initial_model=host_params(seed_net.params),
            n_workers=2, timeout=120.0)
        assert runner.tracker.counter("updates") == len(payloads)
        seed_net.params = params_from_numpy(seed_net, final)
        acc = seed_net.evaluate(ds.features, ds.labels).accuracy()
        assert acc > 0.9, acc

    def test_model_saving_hook_fires(self):
        saves = []
        runner = DistributedRunner()
        runner.simulate(
            payloads=[np.ones(2)] * 6,
            performer_factory=EchoPerformer,
            aggregator=ParameterAveragingAggregator(),
            n_workers=2, timeout=RUN_S,
            save_fn=lambda model, r: saves.append(r), save_every=1)
        assert saves and saves == list(range(1, len(saves) + 1))


class TestWord2VecPerformer:
    def test_delta_training_moves_vectors(self):
        from deeplearning4j_tpu_torch.nlp import Word2Vec

        corpus = [["apple", "banana", "fruit"],
                  ["banana", "apple", "fruit"],
                  ["cpu", "gpu", "chip"],
                  ["gpu", "cpu", "chip"]] * 10
        w2v = Word2Vec(vector_length=16, window=2, epochs=4, seed=3,
                       batch_size=64, **CPU)
        w2v.build_vocab(corpus)
        w2v.reset_weights()
        start = w2v.syn0.copy()

        performer = Word2VecPerformer(w2v)
        job = Job(work=corpus)
        performer.perform(job)
        # perform() emits a delta and restores the replica weights
        np.testing.assert_array_equal(w2v.syn0, start)
        assert not w2v.syn1.any()
        assert np.abs(job.result["syn0"]).sum() > 0
        assert np.abs(job.result["syn1"]).sum() > 0
        w2v.words_nearest("apple")                 # caches the norms
        performer.update(job.result)
        np.testing.assert_array_equal(w2v.syn0, start + job.result["syn0"])
        assert w2v._norms is None and w2v._norms_dev is None


GLOVE_CORPUS = [
    "the cat sat on the mat",
    "the dog sat on the log",
    "cats and dogs are animals",
    "the quick brown fox jumps",
    "dogs chase cats around the yard",
    "a cat and a dog played",
] * 4


class TestGlovePerformer:
    """tests/test_w2v_bridge.py's two GlovePerformer tests."""

    def test_delta_round_trains_embeddings(self):
        from deeplearning4j_tpu_torch.nlp.glove import Glove

        glove = Glove(vector_length=16, window=5, epochs=2, batch_size=256,
                      min_word_frequency=1, **CPU)
        glove.fit(GLOVE_CORPUS)  # builds vocab + seed weights
        start_syn0 = glove.syn0.copy()

        a = GlovePerformer(glove)
        g2 = Glove(vector_length=16, window=5, epochs=2, batch_size=256,
                   min_word_frequency=1, **CPU)
        g2.fit(GLOVE_CORPUS)
        b = GlovePerformer(g2)

        agg = DeltaSumAggregator()
        jobs = [Job(work=GLOVE_CORPUS[:12]), Job(work=GLOVE_CORPUS[12:])]
        a.perform(jobs[0])
        b.perform(jobs[1])
        for j in jobs:
            assert j.done
            assert set(j.result) == set(GlovePerformer.KEYS)
            agg.accumulate(j.result)
        total = agg.aggregate()
        a.update(total)
        assert not np.allclose(a.glove.syn0, start_syn0), \
            "aggregated deltas did not move the embeddings"

    def test_perform_restores_start_weights(self):
        from deeplearning4j_tpu_torch.nlp.glove import Glove

        glove = Glove(vector_length=8, window=3, epochs=1, batch_size=128,
                      **CPU)
        glove.fit(GLOVE_CORPUS)
        before = tuple(p.numpy().copy() for p in glove._params)
        adagrad = tuple(h.numpy().copy() for h in glove._adagrad)
        job = Job(work=GLOVE_CORPUS[:6])
        GlovePerformer(glove).perform(job)
        for p, p0 in zip(glove._params, before):
            np.testing.assert_array_equal(p.numpy(), p0)
        assert any(np.abs(job.result[k]).sum() > 0
                   for k in GlovePerformer.KEYS)
        # the AdaGrad accumulators keep the job's squares (JAX's choice)
        assert any(not np.array_equal(h.numpy(), h0)
                   for h, h0 in zip(glove._adagrad, adagrad))


class TestWordCount:
    def test_distributed_word_count(self):
        from deeplearning4j_tpu_torch.scaleout.text_performers import (
            CounterAggregator,
            WordCountPerformer,
        )

        docs = [["the cat sat on the mat"],
                ["the dog sat"],
                ["a cat and a dog"]]

        def fold(model, agg):
            if model is None:
                return agg
            for k, v in agg.items():
                model.increment(k, v)
            return model

        runner = DistributedRunner()
        result = runner.simulate(
            payloads=docs,
            performer_factory=WordCountPerformer,
            aggregator=CounterAggregator(),
            apply_aggregate=fold,
            n_workers=2, timeout=RUN_S)
        want = collections.Counter(w for d in docs for s in d
                                   for w in s.split())
        assert dict(result.items()) == dict(want)


class TestRepeatedSimulate:
    def test_second_simulate_on_same_runner_works(self):
        class AddOne(WorkerPerformer):
            def __init__(self):
                self.model = 0.0

            def perform(self, job):
                job.result = job.work + 1.0

            def update(self, model):
                self.model = model

        runner = DistributedRunner()
        agg = ParameterAveragingAggregator()
        r1 = runner.simulate([1.0, 3.0], AddOne, agg, n_workers=2,
                             timeout=RUN_S)
        r2 = runner.simulate([5.0, 7.0], AddOne, agg, n_workers=2,
                             timeout=RUN_S)
        assert r1 == 3.0   # mean(2, 4)
        assert r2 == 7.0   # mean(6, 8)

    def test_stop_deregisters_worker_but_kill_does_not(self):
        class Noop:
            def perform(self, job):
                pass

            def update(self, model):
                pass

        tracker = StateTracker()
        w1 = Worker(tracker, Noop(), heartbeat_interval=0.05).start()
        w2 = Worker(tracker, Noop(), heartbeat_interval=0.05).start()
        assert len(tracker.workers()) == 2
        w1.stop(timeout=RUN_S)
        assert w1.worker_id not in tracker.workers()
        w2.kill()   # failure path keeps registration for the reaper
        w2.join(timeout=RUN_S)
        assert not any(t.is_alive() for t in w2._threads)
        assert w2.worker_id in tracker.workers()

    def test_stop_mid_perform_leaves_the_registration(self):
        """A drain that times out leaves the worker registered for the
        reaper (deregistering would re-queue a job whose update still
        posts)."""
        gate, entered = threading.Event(), threading.Event()

        class Held(EchoPerformer):
            def perform(self, job):
                entered.set()
                gate.wait(RUN_S)
                super().perform(job)

        tracker = StateTracker()
        w = Worker(tracker, Held(), heartbeat_interval=0.05).start()
        tracker.enqueue_job(Job(work=np.ones(1), job_id=0))
        assert entered.wait(RUN_S)
        w.stop(timeout=0.05)
        assert w.worker_id in tracker.workers()
        gate.set()
        w.join(timeout=RUN_S)
        assert tracker.counter("updates") == 1

    def test_reset_run_state_clears_stale_jobs_and_updates(self, tmp_path):
        tracker = StateTracker(work_dir=str(tmp_path))
        tracker.add_worker("w1")
        tracker.enqueue_job(Job(work=1.0, job_id=0))
        tracker.enqueue_job(Job(work=2.0, job_id=1))
        assert tracker.request_job("w1") is not None  # now in-flight
        tracker.add_update("w1", 99.0)
        tracker.set_global("g", 1)
        tracker.finish()
        tracker.reset_run_state()
        assert not tracker.is_done()
        assert tracker.pending_jobs() == 0
        assert tracker.current_jobs() == []
        assert tracker.drain_updates() == []
        assert tracker.saved_work() == []
        assert "w1" in tracker.workers()  # registrations survive
        assert tracker.get_global("g") == 1


# ---------------------------------------------------------------------------
# the performers and the aggregators against the JAX package


def _jax_tree(tree):
    return [{k: np.asarray(v) for k, v in p.items()} for p in tree]


def _trees_close(got, want, atol):
    assert [sorted(p) for p in got] == [sorted(p) for p in want]
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], np.asarray(w[k]), atol=atol,
                                       rtol=0)


def test_network_performer_job_matches_jax():
    conf_json = _tiny_net_json()
    init = _numpy_tree(3)
    jp = jso.NetworkPerformer(conf_json)
    tp = NetworkPerformer(conf_json, **CPU)
    for p in (jp, tp):
        p.update(init)
    for seed in (4, 5):             # two jobs: Adam's state carries over
        jjob, tjob = Job(work=_batch(seed)), Job(work=_batch(seed))
        jp.perform(jjob)
        tp.perform(tjob)
        _trees_close(tjob.result, _jax_tree(jjob.result), ATOL)


def test_one_worker_simulate_of_eight_jobs_matches_jax():
    conf_json = _tiny_net_json()
    payloads = [_batch(10 + i) for i in range(8)]
    init = _numpy_tree(1)
    kw = dict(n_workers=1, initial_model=init, timeout=RUN_S)
    want = jso.DistributedRunner().simulate(
        payloads, lambda: jso.NetworkPerformer(conf_json),
        jso.ParameterAveragingAggregator(), **kw)
    runner = DistributedRunner()
    got = runner.simulate(
        payloads, lambda: NetworkPerformer(conf_json, **CPU),
        ParameterAveragingAggregator(), **kw)
    assert runner.tracker.counter("updates") == 8
    _trees_close(got, _jax_tree(want), ATOL)


HS_CORPUS = [" ".join(np.random.default_rng(i).choice(
    ["apple", "banana", "cherry", "mango", "grape"] if i % 2 else
    ["cpu", "gpu", "ram", "disk", "cache"], size=6)) for i in range(80)]


def test_word2vec_performer_hs_delta_matches_jax():
    from deeplearning4j_tpu.nlp import Word2Vec as JW2V
    from deeplearning4j_tpu_torch.nlp import Word2Vec as TW2V

    kw = dict(vector_length=16, window=3, epochs=2, seed=3, batch_size=128)
    models = [JW2V(**kw), TW2V(**kw, **CPU)]
    for m in models:
        m.fit(HS_CORPUS[:40])                    # vocab + seed weights
    jp = jso.Word2VecPerformer(models[0])
    tp = Word2VecPerformer(models[1])
    jjob, tjob = Job(work=HS_CORPUS[40:]), Job(work=HS_CORPUS[40:])
    jp.perform(jjob)
    tp.perform(tjob)
    assert set(tjob.result) == set(jjob.result) == {"syn0", "syn1"}
    for k in jjob.result:
        np.testing.assert_allclose(tjob.result[k],
                                   np.asarray(jjob.result[k]), atol=ATOL,
                                   rtol=0)
    jp.update(jjob.result)
    tp.update(tjob.result)
    np.testing.assert_allclose(models[1].syn0, np.asarray(models[0].syn0),
                               atol=ATOL, rtol=0)


def test_glove_performer_delta_matches_jax():
    from deeplearning4j_tpu.nlp.glove import Glove as JGlove
    from deeplearning4j_tpu_torch.nlp.glove import Glove as TGlove

    kw = dict(vector_length=8, window=4, epochs=3, seed=3, x_max=10.0,
              batch_size=64)
    jg, tg = JGlove(**kw), TGlove(**kw, **CPU)
    jg.fit(GLOVE_CORPUS)
    tg.fit(GLOVE_CORPUS)
    jp, tp = jso.GlovePerformer(jg, epochs=2), GlovePerformer(tg, epochs=2)
    for work in (GLOVE_CORPUS[:10], GLOVE_CORPUS[10:20]):
        jjob, tjob = Job(work=work), Job(work=work)
        jp.perform(jjob)
        tp.perform(tjob)
        for k in GlovePerformer.KEYS:
            np.testing.assert_allclose(tjob.result[k],
                                       np.asarray(jjob.result[k]),
                                       atol=ATOL, rtol=0)
        jp.update(jjob.result)
        tp.update(tjob.result)
        np.testing.assert_allclose(tg.syn0, np.asarray(jg.syn0), atol=ATOL,
                                   rtol=0)


def _mixed_tree(rng):
    """Dicts (keys out of order), lists, tuples and None."""
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"z": [a(2, 3), (a(4), None, a(1))],
            "a": ({"w": a(3), "b": [a(2), a(2, 2)]}, None),
            "s": np.float32(rng.standard_normal())}


def _same_tree(got, want):
    assert type(got) is type(want), (type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _same_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_tree(g, w)
    elif want is not None:
        np.testing.assert_array_equal(got, np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("kind", ["ParameterAveragingAggregator",
                                  "DeltaSumAggregator"])
def test_aggregators_match_jax_on_mixed_trees(kind, n):
    trees = [_mixed_tree(np.random.default_rng(i)) for i in range(n)]
    j, t = getattr(jso, kind)(), getattr(tso, kind)()
    for tree in trees:
        j.accumulate(tree)
        t.accumulate(tree)
    _same_tree(t.aggregate(), j.aggregate())
    t.reset()
    assert t.aggregate() is None


def test_aggregator_refuses_trees_that_differ():
    agg = DeltaSumAggregator()
    agg.accumulate([np.ones(2), np.ones(1)])
    agg.accumulate((np.ones(2), np.ones(1)))
    with pytest.raises(ValueError, match="differ"):
        agg.aggregate()
    agg.reset()
    agg.accumulate({"a": None})
    agg.accumulate({"a": np.ones(1)})
    with pytest.raises(ValueError, match="differ"):
        agg.aggregate()


# ---------------------------------------------------------------------------
# the wire between the packages, and a shared work_dir


@pytest.mark.parametrize("secret", [None, "shared-s3cret"])
@pytest.mark.parametrize("server_side", ["jax", "port"])
def test_control_calls_cross_the_packages(server_side, secret):
    server = (jso if server_side == "jax" else tso).StateTrackerServer(
        secret=secret).start()
    client_mod = tso if server_side == "jax" else jso
    try:
        host, port = server.address
        remote = client_mod.RemoteStateTracker(host, port, secret=secret)
        remote.add_worker("w0")
        assert remote.workers() == ["w0"]
        tree = [{"W": np.arange(6, dtype=np.float32).reshape(2, 3),
                 "b": np.ones(3, np.float32)}]
        remote.set_global("model", tree)
        got = remote.get_global("model")
        np.testing.assert_array_equal(got[0]["W"], tree[0]["W"])
        assert got[0]["W"].dtype == np.float32
        remote.add_update("w0", {"delta": np.full(2, 0.5)})
        (wid, upd), = remote.drain_updates()
        assert wid == "w0" and upd["delta"].tolist() == [0.5, 0.5]
        assert remote.increment("rounds", 2) == 2
        assert server.tracker.counter("updates") == 1
        remote.close()
        if secret:
            bad = client_mod.RemoteStateTracker(host, port, timeout=5.0)
            with pytest.raises((RuntimeError, ConnectionError, OSError)):
                bad.workers()
            bad.close()
    finally:
        server.stop()


@pytest.mark.parametrize("server_side", ["jax", "port"])
def test_a_job_frame_of_the_other_package_is_refused(server_side):
    server = (jso if server_side == "jax" else tso).StateTrackerServer(
        ).start()
    client_mod = tso if server_side == "jax" else jso
    try:
        remote = client_mod.RemoteStateTracker(*server.address, timeout=10)
        with pytest.raises(ConnectionError):
            remote.enqueue_job(client_mod.Job(work=np.arange(2), job_id=0))
        remote.close()
        assert server.tracker.pending_jobs() == 0
        # the server's own Job still crosses from a client of its package
        own = (jso if server_side == "jax" else tso)
        ok = own.RemoteStateTracker(*server.address)
        ok.enqueue_job(own.Job(work=np.arange(2), job_id=0))
        assert ok.pending_jobs() == 1
        ok.close()
    finally:
        server.stop()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_work_dir_crosses_the_packages(writer, tmp_path):
    w_mod, r_mod = (jso, tso) if writer == "jax" else (tso, jso)
    wt = w_mod.StateTracker(work_dir=str(tmp_path))
    work = {"x": np.arange(4, dtype=np.float32), "tokens": ["a", "b"]}
    wt.enqueue_job(w_mod.Job(work=work, job_id=3))
    wt.enqueue_job(w_mod.Job(work=[1, 2], job_id=11))
    wt.add_update("w7", {"d": np.ones(2)})
    rt = r_mod.StateTracker(work_dir=str(tmp_path))
    assert rt.saved_work() == [3, 11]
    got = rt.load_saved_work(3)
    np.testing.assert_array_equal(got["x"], work["x"])
    assert got["tokens"] == ["a", "b"]
    assert rt.load_saved_work(11) == [1, 2]
    assert (tmp_path / "update_w7.pkl").exists()


@pytest.mark.parametrize("backend", ["local", "remote"])
def test_cluster_config_registry_over_the_tracker(backend):
    from deeplearning4j_tpu_torch.runtime.launcher import (
        ClusterConfigRegistry,
    )

    server = None
    tracker = StateTracker()
    if backend == "remote":
        server = StateTrackerServer(tracker).start()
        client = RemoteStateTracker(*server.address)
    try:
        reg = ClusterConfigRegistry(
            tracker=tracker if server is None else client)
        reg.register("job2", {"epochs": 3, "mesh": [2, 4]})
        assert reg.retrieve("job2") == {"epochs": 3, "mesh": [2, 4]}
        assert tracker.get_global("config/job2") is not None
        with pytest.raises(KeyError):
            reg.retrieve("nope")
    finally:
        if server is not None:
            client.close()
            server.stop()


def test_the_global_model_key_is_jax_s():
    from deeplearning4j_tpu.scaleout.runner import MODEL_KEY as JKEY

    assert MODEL_KEY == JKEY
    assert sorted(tso.__all__) == sorted(jso.__all__)


def test_a_master_with_no_workers_times_out():
    master = Master(StateTracker(), JobIterator([1.0]),
                    ParameterAveragingAggregator())
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        master.run(timeout=0.3)
    assert time.monotonic() - t0 < RUN_S
