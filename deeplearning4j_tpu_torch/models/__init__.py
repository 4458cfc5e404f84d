"""Networks (counterpart of `deeplearning4j_tpu.models`): the
`MultiLayerNetwork`, the model zoo's configurations, and the tree models
(`RNTN` with `RNTNEval`, `RecursiveAutoEncoder`)."""

from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork,
    params_from_numpy,
)
from deeplearning4j_tpu_torch.models.recursive_autoencoder import (
    RecursiveAutoEncoder,
)
from deeplearning4j_tpu_torch.models.rntn import RNTN, RNTNEval
from deeplearning4j_tpu_torch.models.zoo import (
    ZOO,
    alexnet_cifar10,
    char_lstm,
    dbn_mnist,
    deep_autoencoder,
    get_model,
    iris_mlp,
    lenet_digits,
    lenet_mnist,
    mnist_mlp,
)

__all__ = [
    "MultiLayerNetwork", "params_from_numpy", "RNTN", "RNTNEval",
    "RecursiveAutoEncoder", "ZOO", "get_model",
    "lenet_mnist", "lenet_digits", "alexnet_cifar10", "char_lstm",
    "dbn_mnist", "deep_autoencoder", "iris_mlp", "mnist_mlp",
]
