"""ctpn_tpu_torch — the CTPN scene-text detector in PyTorch, for one NVIDIA H100.

A port of ``ctpn_tpu`` (JAX/XLA/Pallas). The module names mirror the JAX
package so that each counterpart is easy to find; the public functions keep
its NHWC layouts and output contracts (``CTPNOutputs``, ``Proposals``,
``TextLines``, the (M, 9) line records). This package imports neither JAX
nor any module of ``ctpn_tpu``.

    ops/          anchors, box encode/decode, IoU, anchor targets, greedy
                  NMS (fused kernel, or the suppression bitmask kernel and
                  its resolve), the fused VGG block 1, proposals;
                  hand-written CUDA kernels under
                  ops/csrc/, each a ``torch.library`` op (``ctpn_torch::``)
                  beside its plain PyTorch version
    models/       VGG16 trunk + BiLSTM + CTPN heads (nn.Module)
    postprocess/  text-line connector (H and O modes), detector, line-union
                  pass, the host oracle of the connector
    inference/    end-to-end predictor (device or host post-processing),
                  stream_detect, the frozen artifact
    serving.py    HTTP server with micro-batching (cli/serve.py runs it)
    training/     anchor-target losses, the train step with its optax-exact
                  solvers, the solver loop and its checkpoints
    data/         VOC loader, roidb, minibatches, prefetch, data preparation
                  and the synthetic generator
    parallel/     data-parallel training over torch.distributed
    cli/          serve, demo, export, train and prepare
    eval.py       res_*.txt scoring (ctpn-torch-eval)
    utils/        image preprocessing, weights (load, export, converters),
                  host oracles, device selection; timer.py: the
                  tracing switch, spans (``ctpn.*``) and their totals, the
                  stage clock of the captured program

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; without a CUDA device they raise rather than fall back.
"""

__version__ = "0.1.0"

from ctpn_tpu_torch.config import cfg, cfg_from_file, cfg_from_list, get_cfg  # noqa: F401
