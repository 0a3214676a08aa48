"""Models: the DLRM dense head, the HSTU and FuXi backbones and their
losses, the dense LM (the training backbone, its chunked cross-entropy
and loss; prefill + KV-cache decode), the encoder-decoder and the stub
modality frontend (a VLM's patch embeddings)."""
from .dlrm import (
    DLRM,
    dlrm_forward,
    make_dlrm_loss_fn,
    num_feature_slots,
    pool_tables,
)
from .fuxi import FuXi, fuxi_forward, fuxi_layer, make_fuxi_loss_fn
from .hstu import (
    HSTU,
    hstu_forward,
    hstu_layer,
    make_hstu_loss_fn,
    sequence_infonce,
)
from .encdec import (
    EncDecCache,
    encdec_decode_step,
    encdec_prefill,
    init_encdec_params,
    make_encdec_loss_fn,
    run_decoder,
    run_encoder,
)
from .frontend import frontend_embed_shape, stub_frontend_embeddings
from .layers import apply_norm, init_norm
from .transformer import (
    LMCache,
    init_lm_cache,
    init_lm_params,
    lm_backbone,
    lm_decode_step,
    lm_prefill,
    make_lm_loss_fn,
    vocab_parallel_xent,
)
from .zoo import LMBundle, build_encdec_bundle, build_lm_bundle, train_batch_shapes

__all__ = ["DLRM", "dlrm_forward", "make_dlrm_loss_fn", "num_feature_slots",
           "pool_tables", "FuXi", "fuxi_forward", "fuxi_layer",
           "make_fuxi_loss_fn", "HSTU", "hstu_forward", "hstu_layer",
           "make_hstu_loss_fn", "sequence_infonce", "apply_norm", "init_norm",
           "LMCache", "init_lm_cache", "init_lm_params", "lm_backbone",
           "lm_decode_step", "lm_prefill", "make_lm_loss_fn", "vocab_parallel_xent",
           "EncDecCache", "encdec_decode_step", "encdec_prefill", "init_encdec_params",
           "make_encdec_loss_fn", "run_decoder", "run_encoder",
           "frontend_embed_shape", "stub_frontend_embeddings",
           "LMBundle", "build_encdec_bundle", "build_lm_bundle", "train_batch_shapes"]
