"""Layers and functional ops of the port (counterpart: `paddle_tpu/nn`):
`Layer` (a `torch.nn.Module` with Paddle's methods) and the layers made
from it, `functional`, `initializer`, `utils` and the weight-only
`quant` layers."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from . import utils_mod as utils  # noqa: F401
from .layer import Layer  # noqa: F401
from .common import (  # noqa: F401
    Linear, Embedding, Dropout, Dropout2D, AlphaDropout, Flatten, Identity,
    Upsample, UpsamplingBilinear2D, UpsamplingNearest2D, Pad1D, Pad2D,
    ZeroPad2D, PixelShuffle, PixelUnshuffle, ChannelShuffle, Softmax2D,
    CosineSimilarity, Bilinear, PairwiseDistance, Fold, Unfold,
    ReLU, ReLU6, GELU, SiLU, Swish, Mish, Sigmoid, Tanh, Hardswish,
    Hardsigmoid, Hardtanh, LeakyReLU, ELU, CELU, SELU, Softplus, Softshrink,
    Hardshrink, Softsign, Tanhshrink, LogSigmoid, Softmax, LogSoftmax, GLU,
    PReLU,
)
from .container import (  # noqa: F401
    Sequential, LayerList, LayerDict, ParameterList,
)
from .conv import Conv1D, Conv2D, Conv3D, Conv2DTranspose  # noqa: F401
from .pooling import (  # noqa: F401
    MaxPool2D, AvgPool2D, AdaptiveAvgPool2D, AdaptiveMaxPool2D, MaxPool1D,
    AvgPool1D, MaxUnpool2D,
)
from .norm import (  # noqa: F401
    LayerNorm, RMSNorm, GroupNorm, BatchNorm, BatchNorm1D, BatchNorm2D,
    BatchNorm3D, SyncBatchNorm, InstanceNorm2D, LocalResponseNorm,
)
from .transformer import (  # noqa: F401
    MultiHeadAttention, TransformerEncoderLayer, TransformerEncoder,
    TransformerDecoderLayer, TransformerDecoder, Transformer,
)
from .rnn import (  # noqa: F401
    SimpleRNN, LSTM, GRU, LSTMCell, GRUCell, SimpleRNNCell, BiRNN,
)
from .loss import (  # noqa: F401
    CrossEntropyLoss, MSELoss, L1Loss, SmoothL1Loss, NLLLoss, BCELoss,
    BCEWithLogitsLoss, KLDivLoss, MarginRankingLoss, CosineEmbeddingLoss,
    CTCLoss, TripletMarginLoss, SoftMarginLoss, HingeEmbeddingLoss,
    PoissonNLLLoss, GaussianNLLLoss, MultiLabelSoftMarginLoss,
)
from .clip import (  # noqa: F401
    ClipGradByValue, ClipGradByNorm, ClipGradByGlobalNorm,
)
from .extras_r3 import (  # noqa: F401
    AdaptiveAvgPool1D, AdaptiveMaxPool1D, AdaptiveAvgPool3D,
    AdaptiveMaxPool3D, AvgPool3D, MaxPool3D, Dropout3D, Maxout, RReLU,
    ThresholdedReLU, Pad3D, MultiMarginLoss, TripletMarginWithDistanceLoss,
    HSigmoidLoss, InstanceNorm1D, InstanceNorm3D, Conv1DTranspose,
    Conv3DTranspose, RNN, RNNCellBase, SpectralNorm, BeamSearchDecoder,
)

# the reference's other spellings
Silu = SiLU
MaxUnPool2D = MaxUnpool2D

from . import quant  # noqa: F401,E402  (the weight-only layers)
