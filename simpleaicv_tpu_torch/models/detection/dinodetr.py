"""DINO-DETR (counterpart of ``simpleaicv_tpu/models/detection/dinodetr.py``):
a ResNet backbone's C2-C5 and one stride-2 convolution of C5 as 5 feature
levels, a 6-layer deformable encoder over all their positions, two-stage
selection of the top ``query_nums`` encoder proposals, contrastive
denoising queries in training, and a 6-layer decoder with deformable cross
attention and iterative box refinement against fixed anchors.

Images are NHWC. The backbone computes in ``dtype`` (bf16 by default); the
rest in f32, as in the JAX package. Every deformable attention goes through
``ops.msda.ms_deform_attn``: the hand kernels K7 and K7b on CUDA tensors.
All shapes are static: the collater's square canvas needs no padding mask,
and the denoising queries take a fixed budget of ``2 * dn_number`` slots in
a group layout that follows the batch's largest annotation count on the
device. The four denoising noises come from the ``generator`` passed to
``forward``, drawn in one helper (``draw_dn_noise``) in the JAX order.

State-dict keys follow the JAX tree with ``_N`` as ``.N``:
``input_proj.0``, ``encoder.0.self_attn.sampling_offsets``,
``decoder.5.cross_attn.value_proj``, ``bbox_embed.0.layers.2``,
``label_encoder``, ``level_embed``, ``tgt_embed``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...core.registry import BACKBONES, MODELS
from ...ops.msda import ms_deform_attn
from ..common import (Conv2d, Embed, GroupNorm, LayerNorm, Linear,
                      checkpoint)
from .detr import sine_position_embedding

__all__ = ["DINODETR", "inverse_sigmoid", "sine_embed_4d",
           "resnet18_dinodetr", "resnet34_dinodetr", "resnet50_dinodetr",
           "resnet101_dinodetr", "resnet152_dinodetr"]


def inverse_sigmoid(x, eps: float = 1e-4):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def sine_embed_4d(pos, planes: int = 128):
    """pos [..., 2 or 4] in [0, 1] -> the sine embedding of y, x (and w,
    h), ``planes`` channels each."""
    scale = 2 * math.pi
    dim_t = 10000**(2 * torch.div(torch.arange(planes, device=pos.device), 2,
                                  rounding_mode="floor") / planes)

    def emb(v):
        p = v[..., None] * scale / dim_t
        return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()],
                           dim=-1).reshape(*v.shape, -1)

    parts = [emb(pos[..., 1]), emb(pos[..., 0])]
    if pos.shape[-1] == 4:
        parts += [emb(pos[..., 2]), emb(pos[..., 3])]
    return torch.cat(parts, dim=-1)


class MLPHead(nn.Module):
    """``num_layers`` f32 Linear layers with ReLU between; ``zero_last``
    zero-initialises the last one (the box heads)."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 num_layers: int = 3, zero_last: bool = False):
        super().__init__()
        dims = [in_features] + [hidden] * (num_layers - 1) + [out]
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1],
                   zero_weight=zero_last and i == num_layers - 1)
            for i in range(num_layers))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def _offsets_bias(heads: int, levels: int, points: int):
    """The directional sampling-offset bias: head i points at angle
    2 pi i / heads, point p at (p + 1) times the unit step."""
    thetas = torch.arange(heads, dtype=torch.float32) * (2 * math.pi / heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], -1)
    grid = grid / grid.abs().amax(-1, keepdim=True)
    grid = grid[:, None, None, :].repeat(1, levels, points, 1)
    grid = grid * torch.arange(1, points + 1,
                               dtype=torch.float32)[None, None, :, None]
    return grid.reshape(-1)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention module: offsets and softmax weights
    from the query, samples of the projected value through
    ``ms_deform_attn``."""

    def __init__(self, dim: int, n_levels: int = 5, n_heads: int = 8,
                 n_points: int = 4):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, \
            n_points
        self.sampling_offsets = Linear(
            dim, n_heads * n_levels * n_points * 2, zero_weight=True,
            bias_fill=_offsets_bias(n_heads, n_levels, n_points))
        self.attention_weights = Linear(dim, n_heads * n_levels * n_points,
                                        zero_weight=True)
        self.value_proj = Linear(dim, dim)
        self.output_proj = Linear(dim, dim)

    def forward(self, query, reference_points, value, spatial_shapes):
        """query [B, Lq, C]; reference_points [B, Lq, L, 2 or 4] in [0, 1];
        value [B, S, C]; spatial_shapes a static tuple."""
        b, lq, c = query.shape
        h, l, p = self.n_heads, self.n_levels, self.n_points
        offsets = self.sampling_offsets(query).reshape(b, lq, h, l, p, 2)
        weights = torch.softmax(
            self.attention_weights(query).reshape(b, lq, h, l * p), -1)
        weights = weights.reshape(b, lq, h, l, p)
        v = self.value_proj(value).reshape(b, -1, h, c // h)
        if reference_points.shape[-1] == 2:
            wh = torch.tensor([[w, hh] for hh, w in spatial_shapes],
                              dtype=torch.float32, device=query.device)
            loc = (reference_points[:, :, None, :, None, :]
                   + offsets / wh[None, None, None, :, None, :])
        else:
            ref_xy = reference_points[..., :2]
            ref_wh = reference_points[..., 2:]
            loc = (ref_xy[:, :, None, :, None, :]
                   + offsets / p * ref_wh[:, :, None, :, None, :] * 0.5)
        out = ms_deform_attn(v, spatial_shapes, loc, weights)
        return self.output_proj(out)


class EncoderLayer(nn.Module):

    def __init__(self, dim: int, n_levels: int, head_nums: int,
                 feedforward_planes: int):
        super().__init__()
        self.self_attn = MSDeformAttn(dim, n_levels, head_nums)
        self.norm1 = LayerNorm(dim)
        self.linear1 = Linear(dim, feedforward_planes)
        self.linear2 = Linear(feedforward_planes, dim)
        self.norm2 = LayerNorm(dim)

    def forward(self, src, pos, reference_points, spatial_shapes):
        h = self.self_attn(src + pos, reference_points, src, spatial_shapes)
        src = self.norm1(src + h)
        h = self.linear2(F.relu(self.linear1(src)))
        return self.norm2(src + h)


class SelfAttnWithMask(nn.Module):
    """f32 multi-head attention; ``attn_mask`` [N, N] is True where a query
    may not see a key."""

    def __init__(self, dim: int, head_nums: int):
        super().__init__()
        self.head_nums = head_nums
        self.q, self.k = Linear(dim, dim), Linear(dim, dim)
        self.v, self.out = Linear(dim, dim), Linear(dim, dim)

    def forward(self, q, k, v, attn_mask=None):
        b, n, c = q.shape
        hd = c // self.head_nums
        qh = self.q(q).reshape(b, n, self.head_nums, hd)
        kh = self.k(k).reshape(b, k.shape[1], self.head_nums, hd)
        vh = self.v(v).reshape(b, v.shape[1], self.head_nums, hd)
        attn = torch.einsum("bnhd,bmhd->bhnm", qh, kh) * hd**-0.5
        if attn_mask is not None:
            attn = attn.masked_fill(attn_mask[None, None], -1e9)
        attn = torch.softmax(attn, -1)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, vh)
        return self.out(out.reshape(b, n, c))


class DecoderLayer(nn.Module):

    def __init__(self, dim: int, n_levels: int, head_nums: int,
                 feedforward_planes: int):
        super().__init__()
        self.self_attn = SelfAttnWithMask(dim, head_nums)
        self.norm2 = LayerNorm(dim)
        self.cross_attn = MSDeformAttn(dim, n_levels, head_nums)
        self.norm1 = LayerNorm(dim)
        self.linear1 = Linear(dim, feedforward_planes)
        self.linear2 = Linear(feedforward_planes, dim)
        self.norm3 = LayerNorm(dim)

    def forward(self, tgt, query_pos, reference_points, memory,
                spatial_shapes, self_attn_mask=None):
        q = tgt + query_pos
        h = self.self_attn(q, q, tgt, self_attn_mask)
        tgt = self.norm2(tgt + h)
        h = self.cross_attn(tgt + query_pos, reference_points, memory,
                            spatial_shapes)
        tgt = self.norm1(tgt + h)
        h = self.linear2(F.relu(self.linear1(tgt)))
        return self.norm3(tgt + h)


def _grid_centres(h: int, w: int, device):
    """[h * w, 2] (x, y) centres of a level's cells, normalised."""
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], -1).reshape(-1, 2)


class DINODETR(nn.Module):
    """``forward(x, annotations=None, train=False, generator=None)``: x
    [B, H, W, 3]; annotations [B, M, 5] as normalised (cx, cy, w, h, class),
    class -1 for padding, used for the denoising queries in training.
    Returns a dict: ``pred_logits`` [B, Q, C] and ``pred_boxes`` [B, Q, 4]
    of the last layer, ``aux_pred_*`` of every layer [L, B, Q, ...],
    ``interm_pred_*`` of the selected encoder proposals and their indices
    ``interm_topk_index`` [B, Q] (the port's addition), and in training
    with annotations ``dn_pred_*`` [L, B, 2 * dn_number, ...] and
    ``dn_meta``."""

    def __init__(self, backbone_type: str, hidden_inplanes: int = 256,
                 head_nums: int = 8, query_nums: int = 900,
                 feedforward_planes: int = 2048, encoder_layer_nums: int = 6,
                 decoder_layer_nums: int = 6, num_classes: int = 80,
                 dn_number: int = 100, dn_box_noise_scale: float = 0.4,
                 dn_label_noise_ratio: float = 0.5,
                 use_gradient_checkpoint: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c = hidden_inplanes
        self.hidden_inplanes, self.query_nums = c, query_nums
        self.num_classes, self.dn_number = num_classes, dn_number
        self.dn_box_noise_scale = dn_box_noise_scale
        self.dn_label_noise_ratio = dn_label_noise_ratio
        self.use_gradient_checkpoint = use_gradient_checkpoint
        self.backbone = BACKBONES.create(
            backbone_type, features_only=True, dtype=dtype,
            use_gradient_checkpoint=use_gradient_checkpoint)
        feats = self.backbone.feature_channels
        self.n_levels = n_levels = len(feats) + 1
        self.input_proj = nn.ModuleList(
            [Conv2d(ch, c, 1) for ch in feats]
            + [Conv2d(feats[-1], c, 3, stride=2, padding=1)])
        # torch GroupNorm's eps 1e-5
        self.input_proj_gn = nn.ModuleList(GroupNorm(32, c)
                                           for _ in range(n_levels))
        self.level_embed = nn.Parameter(torch.empty(n_levels, c))
        self.encoder = nn.ModuleList(
            EncoderLayer(c, n_levels, head_nums, feedforward_planes)
            for _ in range(encoder_layer_nums))
        # class heads carry the focal prior: bias -log((1 - 0.01) / 0.01)
        cls_bias = -math.log(99.0)
        self.enc_output = Linear(c, c)
        self.enc_output_norm = LayerNorm(c)
        self.enc_out_class_embed = Linear(c, num_classes, bias_fill=cls_bias)
        self.enc_out_bbox_embed = MLPHead(c, c, 4, 3, zero_last=True)
        self.tgt_embed = nn.Parameter(torch.empty(query_nums, c))
        self.label_encoder = Embed(num_classes + 1, c)
        self.decoder = nn.ModuleList(
            DecoderLayer(c, n_levels, head_nums, feedforward_planes)
            for _ in range(decoder_layer_nums))
        self.ref_point_head = MLPHead(2 * c, c, c, 2)
        self.decoder_norm = LayerNorm(c)
        self.bbox_embed = nn.ModuleList(
            MLPHead(c, c, 4, 3, zero_last=True)
            for _ in range(decoder_layer_nums))
        self.class_embed = nn.ModuleList(
            Linear(c, num_classes, bias_fill=cls_bias)
            for _ in range(decoder_layer_nums))

    def reset_parameters(self, generator):
        with torch.no_grad():
            for p in (self.level_embed, self.tgt_embed):
                p.copy_(torch.randn(p.shape, generator=generator))

    def _layer(self, layer, *args):
        if self.use_gradient_checkpoint and torch.is_grad_enabled():
            return checkpoint(layer, *args)
        return layer(*args)

    def forward(self, x, annotations=None, train: bool = False,
                generator=None):
        c, device = self.hidden_inplanes, x.device
        feats = self.backbone(x, train)
        srcs = [gn(proj(f.float())) for f, proj, gn in
                zip(feats, self.input_proj, self.input_proj_gn)]
        srcs.append(self.input_proj_gn[-1](
            self.input_proj[-1](feats[-1].float())))
        spatial_shapes = tuple((s.shape[1], s.shape[2]) for s in srcs)
        b = x.shape[0]

        # the sine embedding of an unpadded canvas is the same for every
        # image: one copy, broadcast over the batch
        src = torch.cat([s.reshape(b, -1, c) for s in srcs], 1)
        pos = torch.cat([
            sine_position_embedding(torch.zeros(1, hh, ww, device=device),
                                    c // 2).reshape(1, hh * ww, c)
            + self.level_embed[lvl]
            for lvl, (hh, ww) in enumerate(spatial_shapes)], 1)

        # encoder reference points: every level's cell centres
        centres = [_grid_centres(hh, ww, device) for hh, ww in spatial_shapes]
        enc_ref = torch.cat(centres, 0)[None, :, None, :].expand(
            1, -1, self.n_levels, 2)
        memory = src
        for layer in self.encoder:
            memory = self._layer(layer, memory, pos, enc_ref, spatial_shapes)

        # two-stage proposal selection
        proposals = torch.cat([
            torch.cat([cells, torch.full_like(cells, 0.05 * 2.0**lvl)], -1)
            for lvl, cells in enumerate(centres)], 0)[None]   # [1, S, 4]
        valid = ((proposals > 0.01) & (proposals < 0.99)).all(-1)
        # 1e8 stands for the reference's +inf: sigmoid-identical, no inf * 0
        proposals_unsig = torch.where(valid[..., None],
                                      inverse_sigmoid(proposals),
                                      torch.full_like(proposals, 1e8))
        # the memory at invalid positions is zeroed before the head
        out_mem = self.enc_output_norm(self.enc_output(
            torch.where(valid[..., None], memory, torch.zeros_like(memory))))
        enc_cls = self.enc_out_class_embed(out_mem)
        enc_coord_unsig = self.enc_out_bbox_embed(out_mem) + proposals_unsig
        # top-k over the unmasked best class logit
        topk_idx = enc_cls.amax(-1).topk(self.query_nums, dim=1).indices
        coord_topk = enc_coord_unsig.gather(
            1, topk_idx[..., None].expand(-1, -1, 4))
        ref_unsig = coord_topk.detach()
        interm_coord = torch.sigmoid(coord_topk)
        interm_cls = enc_cls.gather(
            1, topk_idx[..., None].expand(-1, -1, self.num_classes))

        tgt = self.tgt_embed[None].expand(b, -1, -1)
        # the label encoder takes part at eval too, with no effect
        tgt = tgt + 0.0 * self.label_encoder(
            torch.zeros((), dtype=torch.long, device=device))

        dn_meta, attn_mask = None, None
        if train and annotations is not None and self.dn_number > 0:
            dn_tgt, dn_ref_unsig, attn_mask, dn_meta = self._prepare_dn(
                annotations, generator)
            tgt = torch.cat([dn_tgt, tgt], 1)
            ref_unsig = torch.cat([dn_ref_unsig, ref_unsig], 1)

        # the decoder keeps its initial anchors: cross attention and the
        # query position use ref0 at every layer; layer i's box chain is
        # sigmoid(bbox_embed_i(out_i) + invsig(ref0)), and its reported box
        # the delta on the normed state against the previous chain value
        ref0 = torch.sigmoid(ref_unsig)
        ref_input = ref0[:, :, None, :].expand(-1, -1, self.n_levels, -1)
        query_pos = self.ref_point_head(sine_embed_4d(ref0, c // 2))
        ref0_unsig = inverse_sigmoid(ref0)
        hs_list, ref_list = [], [ref0]
        out = tgt
        for i, layer in enumerate(self.decoder):
            out = self._layer(layer, out, query_pos, ref_input, memory,
                              spatial_shapes, attn_mask)
            ref_list.append(torch.sigmoid(self.bbox_embed[i](out)
                                          + ref0_unsig))
            hs_list.append(self.decoder_norm(out))
        cls_outputs = torch.stack([head(h) for head, h in
                                   zip(self.class_embed, hs_list)], 0)
        coord_outputs = torch.stack([
            torch.sigmoid(self.bbox_embed[i](h) + inverse_sigmoid(ref_list[i]))
            for i, h in enumerate(hs_list)], 0)

        outputs = {}
        if dn_meta is not None:
            pad = dn_meta["pad_size"]
            outputs["dn_pred_logits"] = cls_outputs[:, :, :pad]
            outputs["dn_pred_boxes"] = coord_outputs[:, :, :pad]
            outputs["dn_meta"] = dn_meta
            cls_outputs = cls_outputs[:, :, pad:]
            coord_outputs = coord_outputs[:, :, pad:]
        outputs["pred_logits"] = cls_outputs[-1]
        outputs["pred_boxes"] = coord_outputs[-1]
        outputs["aux_pred_logits"] = cls_outputs
        outputs["aux_pred_boxes"] = coord_outputs
        outputs["interm_pred_logits"] = interm_cls
        outputs["interm_pred_boxes"] = interm_coord
        outputs["interm_topk_index"] = topk_idx
        return outputs

    def draw_dn_noise(self, generator, b: int, pad: int, device):
        """The four denoising noises, in the JAX package's order: label flips
        (Bernoulli of ``dn_label_noise_ratio / 2``) [B, pad], random classes
        [B, pad], box noise in [-1, 1) [B, pad, 4], and the negatives' scale
        in [1, 2) [B, pad, 4]."""
        flip = torch.rand((b, pad), generator=generator, device=device) \
            < self.dn_label_noise_ratio * 0.5
        rand_cls = torch.randint(0, self.num_classes, (b, pad),
                                 generator=generator, device=device)
        noise = torch.rand((b, pad, 4), generator=generator,
                           device=device) * 2.0 - 1.0
        neg_extra = torch.rand((b, pad, 4), generator=generator,
                               device=device) + 1.0
        return flip, rand_cls, noise, neg_extra

    def _prepare_dn(self, annotations, generator):
        """Contrastive denoising queries in a static budget of
        ``pad = 2 * dn_number`` slots. With m the batch's largest valid
        annotation count (on the device, no host read), a group is 2m slots,
        m positive and m negative copies of the annotations, and there are
        ``max(dn_number // m, 1)`` groups; slot s holds annotation
        ``(s % 2m) % m`` of group ``s // 2m``."""
        b, m_all = annotations.shape[:2]
        device = annotations.device
        cls_all = annotations[..., 4]
        num_valid = (cls_all >= 0).long().sum(1)                 # [B]
        m_dyn = num_valid.max().clamp(1, m_all)
        g_dyn = (self.dn_number // m_dyn).clamp(min=1)
        pad = 2 * self.dn_number

        s = torch.arange(pad, device=device)
        group_id = torch.div(s, 2 * m_dyn, rounding_mode="floor")
        within = s % (2 * m_dyn)
        is_neg = within >= m_dyn
        gt_idx = within % m_dyn
        valid = (group_id < g_dyn)[None, :] & (gt_idx[None, :]
                                               < num_valid[:, None])
        take = gt_idx[None].expand(b, pad)
        cls_t = cls_all.gather(1, take)
        box_t = annotations[..., :4].float().gather(
            1, take[..., None].expand(-1, -1, 4))

        flip, rand_cls, noise, neg_extra = self.draw_dn_noise(
            generator, b, pad, device)
        noised_cls = torch.where(flip, rand_cls.to(cls_t.dtype),
                                 cls_t.clamp(min=0))
        # box noise: positive slots at scale 1, negative ones in (1, 2]
        diff = torch.cat([box_t[..., 2:] / 2, box_t[..., 2:]], -1)
        sign = torch.where(noise >= 0, 1.0, -1.0)
        pos_noise = noise * diff * self.dn_box_noise_scale
        neg_noise = sign * neg_extra * diff * self.dn_box_noise_scale
        noised_box = box_t + torch.where(is_neg[None, :, None], neg_noise,
                                         pos_noise)
        noised_box = noised_box.clamp(0.0, 1.0)

        dn_tgt = self.label_encoder(noised_cls.long())
        # padding slots carry a zero embedding
        dn_tgt = torch.where(valid[..., None], dn_tgt,
                             torch.zeros_like(dn_tgt))
        dn_ref_unsig = inverse_sigmoid(noised_box)

        # [pad + Q, pad + Q], True = blocked: matching queries cannot see
        # the dn slots, and dn groups cannot see each other
        total = pad + self.query_nums
        mask = torch.zeros((total, total), dtype=torch.bool, device=device)
        mask[pad:, :pad] = True
        mask[:pad, :pad] = group_id[:, None] != group_id[None, :]
        dn_meta = {"pad_size": pad, "dn_gt_index": take, "dn_valid": valid,
                   "dn_is_positive": (~is_neg)[None].expand(b, pad)}
        return dn_tgt, dn_ref_unsig, mask, dn_meta


def _dinodetr(backbone_type, **kwargs):
    kwargs.pop("backbone_pretrained_path", None)
    return DINODETR(backbone_type=backbone_type, **kwargs)


@MODELS.register()
def resnet18_dinodetr(**kwargs):
    return _dinodetr("resnet18", **kwargs)


@MODELS.register()
def resnet34_dinodetr(**kwargs):
    return _dinodetr("resnet34", **kwargs)


@MODELS.register()
def resnet50_dinodetr(**kwargs):
    return _dinodetr("resnet50", **kwargs)


@MODELS.register()
def resnet101_dinodetr(**kwargs):
    return _dinodetr("resnet101", **kwargs)


@MODELS.register()
def resnet152_dinodetr(**kwargs):
    return _dinodetr("resnet152", **kwargs)
