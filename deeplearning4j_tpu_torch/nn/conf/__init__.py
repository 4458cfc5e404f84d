from deeplearning4j_tpu_torch.nn.conf.layers import (
    LayerConf,
    DenseLayerConf,
    OutputLayerConf,
    ConvolutionLayerConf,
    SubsamplingLayerConf,
    BatchNormConf,
    GravesLSTMConf,
    LSTMConf,
    GRUConf,
    EmbeddingLayerConf,
    AutoEncoderConf,
    RBMConf,
    RnnOutputLayerConf,
    DropoutLayerConf,
    ActivationLayerConf,
    layer_conf_from_dict,
)
from deeplearning4j_tpu_torch.nn.conf.config import (
    NeuralNetConfiguration,
    MultiLayerConfiguration,
)

__all__ = [
    "LayerConf", "DenseLayerConf", "OutputLayerConf", "ConvolutionLayerConf",
    "SubsamplingLayerConf", "BatchNormConf", "GravesLSTMConf", "LSTMConf",
    "GRUConf", "EmbeddingLayerConf", "AutoEncoderConf", "RBMConf",
    "RnnOutputLayerConf", "DropoutLayerConf", "ActivationLayerConf",
    "layer_conf_from_dict", "NeuralNetConfiguration", "MultiLayerConfiguration",
]
