"""Networks (counterpart of `deeplearning4j_tpu.models`): the
`MultiLayerNetwork` and the model zoo's configurations."""

from deeplearning4j_tpu_torch.models.multi_layer_network import (
    MultiLayerNetwork,
    params_from_numpy,
)
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
    "MultiLayerNetwork", "params_from_numpy", "ZOO", "get_model",
    "lenet_mnist", "lenet_digits", "alexnet_cifar10", "char_lstm",
    "dbn_mnist", "deep_autoencoder", "iris_mlp", "mnist_mlp",
]
