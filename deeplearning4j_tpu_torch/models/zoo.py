"""Model zoo: the named architectures the baselines are defined over
(counterpart of `deeplearning4j_tpu.models.zoo`, builder for builder).

BASELINE.md names its configs by architecture — LeNet-5 on MNIST (#1) and
AlexNet on CIFAR-10 for the 8-way data-parallel scaling row (#5, reference
`SparkDl4jMultiLayer.java:182-202` trains the per-executor replicas that
these correspond to).  The 2015 reference has no model-zoo module (users
hand-assemble configs in examples/tests, e.g. the conv stacks in
`deeplearning4j-core/src/test/java/.../TestConvolutionLayer.java`); for the
TPU framework the canonical architectures live here so the CLI, the bench
harness and the tests all train the same graph.

All builders return a plain `MultiLayerConfiguration` — nothing here is a
special model class, so every zoo entry works with `MultiLayerNetwork`,
`DataParallelTrainer`, checkpointing and the CLI unchanged.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf import (
    ConvolutionLayerConf,
    DenseLayerConf,
    GravesLSTMConf,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
    OutputLayerConf,
    RnnOutputLayerConf,
    SubsamplingLayerConf,
)


def lenet_mnist(updater: str = "adam", learning_rate: float = 0.01,
                seed: int = 0, compute_dtype: str = "float32"
                ) -> MultiLayerConfiguration:
    """LeNet-5 for 28x28x1 MNIST (BASELINE.md config #1).

    Conv(6,5x5,SAME) -> pool -> Conv(16,5x5) -> pool -> 120 -> 84 -> 10,
    NHWC throughout.
    """
    return MultiLayerConfiguration(
        conf=NeuralNetConfiguration(learning_rate=learning_rate,
                                    updater=updater, seed=seed,
                                    compute_dtype=compute_dtype),
        layers=(
            ConvolutionLayerConf(n_in=1, n_out=6, kernel_size=(5, 5),
                                 padding="SAME"),
            SubsamplingLayerConf(),
            ConvolutionLayerConf(n_in=6, n_out=16, kernel_size=(5, 5)),
            SubsamplingLayerConf(),
            DenseLayerConf(n_in=400, n_out=120, activation="relu"),
            DenseLayerConf(n_in=120, n_out=84, activation="relu"),
            OutputLayerConf(n_in=84, n_out=10),
        ),
        input_preprocessors={"4": {"type": "cnn_to_ffn"}},
    )


def alexnet_cifar10(updater: str = "sgd", learning_rate: float = 0.01,
                    dropout: float = 0.5, seed: int = 0,
                    compute_dtype: str = "float32") -> MultiLayerConfiguration:
    """AlexNet adapted to 32x32x3 CIFAR-10 (BASELINE.md config #5).

    The ImageNet AlexNet's 11x11/stride-4 stem assumes 224x224 inputs; on
    CIFAR the standard adaptation keeps the five-conv / three-pool body and
    the two dropout-regularised dense layers but uses 3x3 kernels:

        conv 64 -> pool -> conv 192 -> pool -> conv 384 -> conv 256
        -> conv 256 -> pool -> fc 1024 -> fc 512 -> softmax 10

    32x32 -> 16 -> 8 -> 4 spatially, so the flatten feeds 4*4*256 = 4096
    features.
    """
    conv = dict(kernel_size=(3, 3), padding="SAME")
    return MultiLayerConfiguration(
        conf=NeuralNetConfiguration(learning_rate=learning_rate,
                                    updater=updater, seed=seed,
                                    compute_dtype=compute_dtype),
        layers=(
            ConvolutionLayerConf(n_in=3, n_out=64, **conv),
            SubsamplingLayerConf(),
            ConvolutionLayerConf(n_in=64, n_out=192, **conv),
            SubsamplingLayerConf(),
            ConvolutionLayerConf(n_in=192, n_out=384, **conv),
            ConvolutionLayerConf(n_in=384, n_out=256, **conv),
            ConvolutionLayerConf(n_in=256, n_out=256, **conv),
            SubsamplingLayerConf(),
            DenseLayerConf(n_in=4096, n_out=1024, activation="relu",
                           dropout=dropout),
            DenseLayerConf(n_in=1024, n_out=512, activation="relu",
                           dropout=dropout),
            OutputLayerConf(n_in=512, n_out=10),
        ),
        input_preprocessors={"8": {"type": "cnn_to_ffn"}},
    )


def lenet_digits(updater: str = "adam", learning_rate: float = 0.01,
                 seed: int = 0, compute_dtype: str = "float32"
                 ) -> MultiLayerConfiguration:
    """LeNet-style conv net for the 8x8x1 REAL digits fixture
    (`datasets.fetchers.digits_dataset`) — the offline convergence-gate
    model (the role the reference's bundled-fixture tests play,
    `MultiLayerTest.java:120`): Conv(16,3x3) -> pool -> Conv(32,3x3) ->
    pool -> 64 -> 10 on an 8 -> 4 -> 2 spatial pyramid."""
    return MultiLayerConfiguration(
        conf=NeuralNetConfiguration(learning_rate=learning_rate,
                                    updater=updater, seed=seed,
                                    compute_dtype=compute_dtype),
        layers=(
            ConvolutionLayerConf(n_in=1, n_out=16, kernel_size=(3, 3),
                                 padding="SAME"),
            SubsamplingLayerConf(),
            ConvolutionLayerConf(n_in=16, n_out=32, kernel_size=(3, 3),
                                 padding="SAME"),
            SubsamplingLayerConf(),
            DenseLayerConf(n_in=128, n_out=64, activation="relu"),
            OutputLayerConf(n_in=64, n_out=10),
        ),
        input_preprocessors={"4": {"type": "cnn_to_ffn"}},
    )


def char_lstm(vocab_size: int = 80, hidden: int = 256,
              updater: str = "adam", learning_rate: float = 0.01,
              seed: int = 0, compute_dtype: str = "float32"
              ) -> MultiLayerConfiguration:
    """Character-level LSTM language model (BASELINE.md config #4, the
    `GravesLSTM.java:47` parity workload)."""
    return MultiLayerConfiguration(
        conf=NeuralNetConfiguration(learning_rate=learning_rate,
                                    updater=updater, seed=seed,
                                    compute_dtype=compute_dtype),
        layers=(GravesLSTMConf(n_in=vocab_size, n_out=hidden),
                RnnOutputLayerConf(n_in=hidden, n_out=vocab_size)),
    )


def dbn_mnist(layer_sizes: tuple = (784, 256, 128), n_out: int = 10,
              updater: str = "sgd", learning_rate: float = 0.05,
              k: int = 1, seed: int = 0) -> MultiLayerConfiguration:
    """Deep belief network for MNIST-shaped data: stacked binary RBMs
    with greedy layer-wise CD-k pretraining, finetuned through a softmax
    head — THE flagship model family of the 2015 reference (its tests
    and examples train DBNs, e.g. `MultiLayerTest.java:163` testDbn;
    pretrain flag `MultiLayerConfiguration.java:50`, greedy loop
    `MultiLayerNetwork.pretrain():148`)."""
    from deeplearning4j_tpu_torch.nn.conf.layers import RBMConf

    rbms = tuple(
        RBMConf(n_in=layer_sizes[i], n_out=layer_sizes[i + 1], k=k,
                visible_unit="binary", hidden_unit="binary")
        for i in range(len(layer_sizes) - 1))
    return MultiLayerConfiguration(
        conf=NeuralNetConfiguration(learning_rate=learning_rate,
                                    updater=updater, seed=seed),
        layers=rbms + (OutputLayerConf(n_in=layer_sizes[-1], n_out=n_out),),
        pretrain=True,
    )


def deep_autoencoder(layer_sizes: tuple = (784, 256, 64, 16),
                     updater: str = "adam", learning_rate: float = 1e-3,
                     corruption_level: float = 0.0, seed: int = 0
                     ) -> MultiLayerConfiguration:
    """Deep (denoising) autoencoder: stacked AE layers pretrained
    greedily, then the full encoder-decoder finetuned on reconstruction
    — the reference's Curves workload (`CurvesDataFetcher` feeding
    stacked `autoencoder/AutoEncoder.java` layers;
    `ReconstructionDataSetIterator` supplies labels=features).  The
    decoder mirrors the encoder; the sigmoid head + xent loss fit
    [0,1]-valued inputs (curves pixels, MNIST)."""
    from deeplearning4j_tpu_torch.nn.conf.layers import AutoEncoderConf

    encoder = tuple(
        AutoEncoderConf(n_in=layer_sizes[i], n_out=layer_sizes[i + 1],
                        corruption_level=corruption_level,
                        activation="sigmoid")
        for i in range(len(layer_sizes) - 1))
    decoder = tuple(
        DenseLayerConf(n_in=layer_sizes[i + 1], n_out=layer_sizes[i],
                       activation="sigmoid")
        for i in reversed(range(1, len(layer_sizes) - 1)))
    head = OutputLayerConf(n_in=layer_sizes[1], n_out=layer_sizes[0],
                           activation="sigmoid", loss="xent")
    return MultiLayerConfiguration(
        conf=NeuralNetConfiguration(learning_rate=learning_rate,
                                    updater=updater, seed=seed),
        layers=encoder + decoder + (head,),
        pretrain=True,
    )


def iris_mlp(updater: str = "adam", learning_rate: float = 0.02,
             seed: int = 3) -> MultiLayerConfiguration:
    """3-layer MLP for Iris (BASELINE.md config #2, the CLI convergence
    config of `Train.java:151` / `MultiLayerTest.java:120`)."""
    return MultiLayerConfiguration(
        conf=NeuralNetConfiguration(learning_rate=learning_rate,
                                    updater=updater, seed=seed),
        layers=(DenseLayerConf(n_in=4, n_out=16, activation="relu"),
                DenseLayerConf(n_in=16, n_out=16, activation="relu"),
                OutputLayerConf(n_in=16, n_out=3)),
    )


def mnist_mlp(updater: str = "adam", learning_rate: float = 0.01,
              seed: int = 5, width: int = 2048) -> MultiLayerConfiguration:
    """MNIST-class wide MLP classifier (784-width-width-10) — the serving
    benchmark's model (bench.py bench_serving): wide enough that a
    single-request forward is weight-bandwidth-bound, which is exactly
    the regime where micro-batched serving wins (one pass over the
    weights serves the whole coalesced batch)."""
    return MultiLayerConfiguration(
        conf=NeuralNetConfiguration(learning_rate=learning_rate,
                                    updater=updater, seed=seed),
        layers=(DenseLayerConf(n_in=784, n_out=width, activation="relu"),
                DenseLayerConf(n_in=width, n_out=width, activation="relu"),
                OutputLayerConf(n_in=width, n_out=10)),
    )


ZOO = {
    "lenet-mnist": lenet_mnist,
    "mnist-mlp": mnist_mlp,
    "lenet-digits": lenet_digits,
    "alexnet-cifar10": alexnet_cifar10,
    "char-lstm": char_lstm,
    "iris-mlp": iris_mlp,
    "dbn-mnist": dbn_mnist,
    "deep-autoencoder": deep_autoencoder,
}


def get_model(name: str, **kw) -> MultiLayerConfiguration:
    if name not in ZOO:
        raise KeyError(f"unknown zoo model '{name}'; known: {sorted(ZOO)}")
    return ZOO[name](**kw)
