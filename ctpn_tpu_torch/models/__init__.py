"""CTPN model family: VGG16 trunk + BiLSTM row encoder + RPN heads."""

from ctpn_tpu_torch.models.ctpn import CTPN, CTPNOutputs  # noqa: F401
from ctpn_tpu_torch.models.factory import get_network  # noqa: F401
