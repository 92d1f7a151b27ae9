"""Datasets and input pipeline: VOC loader, roidb, minibatch, prefetch,
data preparation and the synthetic generator (host code)."""

from ctpn_tpu_torch.data.voc import PascalVOC, get_imdb, list_imdbs  # noqa: F401
from ctpn_tpu_torch.data.roidb import prepare_roidb, get_training_roidb  # noqa: F401
from ctpn_tpu_torch.data.minibatch import RoIDataLayer  # noqa: F401
from ctpn_tpu_torch.data.pipeline import PrefetchLoader  # noqa: F401
