"""``repro_torch.quant``: int8 for the SoC's fixed-point MAC path
(``repro/quant``), with fake-quant for QAT.

    from repro_torch import quant
    from repro_torch.core import basecaller as bc

    calib   = quant.calibrate(bc.layer_inputs_stream(params, chunks, cfg),
                              observer="percentile", pct=99.9)
    qparams = quant.quantize_params(params, calib)
    logits  = bc.apply(qparams, signal, cfg)      # int8 MACs, no requant
"""
from repro_torch.quant.core import (EPS, QMAX, QuantizedTensor,  # noqa: F401
                                    absmax, dequantize, is_quantized,
                                    quantize, quantize_tensor,
                                    symmetric_scale)
from repro_torch.quant.fake_quant import (fake_quant,  # noqa: F401
                                          fake_quant_activation,
                                          fake_quant_params)
from repro_torch.quant.observers import (MinMaxObserver,  # noqa: F401
                                         PercentileObserver, make_observer)
from repro_torch.quant.params import (DEFAULT_WEIGHT_KEYS,  # noqa: F401
                                      Calibration, calibrate,
                                      dequantize_params, params_precision,
                                      quantize_params, quantized_fraction,
                                      select_weight_leaf)
