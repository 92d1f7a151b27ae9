"""ctpn_tpu_torch — the CTPN scene-text detector in PyTorch, for one NVIDIA H100.

A port of ``ctpn_tpu`` (JAX/XLA/Pallas). The module names mirror the JAX
package so that each counterpart is easy to find; the public functions keep
its NHWC layouts and output contracts (``CTPNOutputs``, ``Proposals``,
``TextLines``, the (M, 9) line records). This package imports neither JAX
nor any module of ``ctpn_tpu``.

    ops/          anchors, box decode, greedy NMS (hand-written CUDA kernel
                  under ops/csrc/ and its plain PyTorch version), proposals
    models/       VGG16 trunk + BiLSTM + CTPN heads (nn.Module)
    postprocess/  H-mode text-line connector, detector, line-union pass
    inference/    end-to-end predictor
    utils/        image preprocessing, weight loading, device selection

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; without a CUDA device they raise rather than fall back.
"""

__version__ = "0.1.0"

from ctpn_tpu_torch.config import cfg, cfg_from_file, cfg_from_list, get_cfg  # noqa: F401
