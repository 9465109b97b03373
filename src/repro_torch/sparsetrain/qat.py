"""Quantization-aware training over the masked-sparse training form.

``fake_quant_params`` takes parameters that have **already been masked**
(``masks.apply_mask_tree`` / ``train_loop.premask_params``) and replaces
every sparse linear's weight by its straight-through fake-quantized image
(``ste.fake_quant_weight``).  The forward pass then computes exactly what
``pack_tree(..., quantize="int8")`` will serve — the same amax scales, the
same round to nearest even, the same ±127 clip — while gradients pass
straight through to the dense weight.

Only *sparse* linears are fake-quantized: they are the nodes ``pack_tree``
packs and quantizes, so QAT mirrors the serving conversion exactly — dense
projections (norms, embeddings) serve and train in full precision.
``granularity`` picks the scale unit of the (xwT-layout) serving form:
``per_row`` (default) or ``per_group``.
"""

from __future__ import annotations

from repro_torch.sparsetrain.ste import GRANULARITIES, fake_quant_weight

QAT_DTYPES = ("int8",)


def validate_qat(qdtype, granularity: str = "per_row"):
    if qdtype is not None and qdtype not in QAT_DTYPES:
        raise ValueError(f"unknown QAT dtype {qdtype!r}; expected one of "
                         f"{QAT_DTYPES}")
    if granularity not in GRANULARITIES:
        raise ValueError(f"unknown QAT granularity {granularity!r}; "
                         f"expected one of {GRANULARITIES}")


def fake_quant_params(params: dict, sparsity: dict,
                      granularity: str = "per_row") -> dict:
    """Fake-quantize every sparse weight (the names in ``sparsity``) of a
    masked parameter dict."""
    return {name: (fake_quant_weight(p, m=sparsity[name].m,
                                     granularity=granularity)
                   if name in sparsity else p)
            for name, p in params.items()}
