"""Model FLOPs of a step, counted from a configuration's shapes.

Matrix products only, 2 FLOPs a multiply-add.  No embedding gather,
no norm, activation or softmax; causal attention counts the pairs its
mask leaves visible.  A training step is 3x its forward.  These counts
belong to the benchmark: the program's own (``utils.metrics``) counts
the embedding as a product and lets an environment variable replace
the peak, so it is not read.
"""

from __future__ import annotations

from portbench.frozen import visible_pairs

# ResNet bottleneck plans (He et al. 2015, table 1)
RESNET_PLANS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def lm_matmul_params(cfg):
    """Weights that take part in a product for every token: the blocks'
    qkv, output, and two MLP projections, and the head."""
    d, m, nl = cfg["hidden_size"], cfg["intermediate_size"], \
        cfg["num_hidden_layers"]
    return nl * (d * 3 * d + d * d + 2 * d * m) + d * cfg["vocab_size"]


def lm_forward_flops(cfg, seq_len):
    """Forward FLOPs of one sequence of ``seq_len`` tokens, causal."""
    d, nl = cfg["hidden_size"], cfg["num_hidden_layers"]
    return (2.0 * seq_len * lm_matmul_params(cfg)
            + 4.0 * d * nl * visible_pairs(seq_len, seq_len, True))


def lm_train_step_flops(cfg, batch, seq_len):
    return 3.0 * batch * lm_forward_flops(cfg, seq_len)


def lm_decode_flops(cfg, context_len):
    """Forward FLOPs of one decoded token that attends to
    ``context_len`` positions (itself included)."""
    d, nl = cfg["hidden_size"], cfg["num_hidden_layers"]
    return 2.0 * lm_matmul_params(cfg) + 4.0 * d * nl * context_len


def resnet_forward_macs(depth=50, image=224, num_classes=1000, width=64):
    """Multiply-adds of one image through the ImageNet bottleneck plan:
    the 7x7/2 stem, the 3x3/2 max pool, stages of bottleneck blocks
    (stride on the 3x3), a projection where the shape changes, the fc."""
    def out(size, stride):
        return -(-size // stride)

    s = out(image, 2)
    macs = s * s * 7 * 7 * 3 * width
    s = out(s, 2)
    in_ch = width
    for stage, blocks in enumerate(RESNET_PLANS[depth]):
        ch = width * 2 ** stage
        for b in range(blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            so = out(s, stride)
            macs += s * s * in_ch * ch              # 1x1
            macs += so * so * 9 * ch * ch           # 3x3, strided
            macs += so * so * ch * 4 * ch           # 1x1
            if stride != 1 or in_ch != 4 * ch:
                macs += so * so * in_ch * 4 * ch    # projection
            in_ch, s = 4 * ch, so
    return macs + in_ch * num_classes


def resnet_train_step_flops(cfg, batch):
    return 3.0 * 2.0 * batch * resnet_forward_macs(
        cfg["depth"], cfg["image_size"], cfg["num_classes"], cfg["width"])
