"""The traffic generator: deterministic by seed, the same set of sizes
for every seed, and the mixes' stated shapes."""

import numpy as np

from benchmark import gen, spec


def test_serve_requests_repeat_by_seed():
    mix = spec.traffic("chat")
    a = gen.ServeRequests(mix, 50257, 2 ** 31 + 17)
    b = gen.ServeRequests(mix, 50257, 2 ** 31 + 17)
    c = gen.ServeRequests(mix, 50257, 5)
    for i in (0, 63, 64, 1000):
        assert a.request(i) == b.request(i)
    assert any(a.request(i) != c.request(i) for i in range(8))


def test_every_seed_gets_the_same_sizes_in_another_order():
    mix = spec.traffic("chat")
    blocks = []
    for seed in (1, 2, 3 ** 20):
        r = gen.ServeRequests(mix, 50257, seed)
        blocks.append([sorted(r.sizes(i)[k] for i in range(64, 128))
                       for k in range(3)])
    assert blocks[0] == blocks[1] == blocks[2]
    assert len({r.sizes(i) for i in range(64)}) > 1


def test_chat_shape():
    mix = spec.traffic("chat")
    r = gen.ServeRequests(mix, 50257, 9)
    sizes = [r.sizes(i) for i in range(64)]
    assert all(32 <= u <= 256 and 128 <= o <= 256 for u, o, _ in sizes)
    shares = []
    for i in range(64):
        prompt, n_out = r.request(i)
        assert len(prompt) + n_out <= 1024
        shares.append(384 / len(prompt))
        assert prompt[:384] in r.prefixes
    assert 0.70 < np.mean(shares) < 0.78


def test_rag_shape():
    mix = spec.traffic("rag")
    r = gen.ServeRequests(mix, 50257, 9)
    for i in range(64):
        prompt, n_out = r.request(i)
        assert 512 <= len(prompt) <= 896 and 16 <= n_out <= 64
        assert len(prompt) + n_out <= 1024


def test_train_batches_repeat_by_seed_and_follow_zipf():
    mix = spec.traffic("pretrain")
    small = dict(mix, staged_batches=2, global_batch=4, seq_len=255)
    a = gen.train_batches(small, 50257, 2 ** 32 + 1)
    b = gen.train_batches(small, 50257, 2 ** 32 + 1)
    assert a.shape == (2, 4, 256) and (a == b).all()
    assert not (a == gen.train_batches(small, 50257, 3)).all()
    assert a.min() >= 0 and a.max() < 50257
    # the most frequent id takes about 1 / H(V, 1.1) of the draws
    _, counts = np.unique(a, return_counts=True)
    top = counts.max() / a.size
    h = (np.arange(1, 50258, dtype=np.float64) ** -1.1).sum()
    assert 0.5 / h < top < 2.0 / h
