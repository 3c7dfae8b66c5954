"""The plain reference of a decoder served on the ``q16_16`` rung.

Plain PyTorch, written from the configuration's equations and imports
nothing of the program.  It takes the benchmark's float32 weights (the
same tensors the server was given) and works out again everything the
program derives from them: the int8 weights with one power-of-two
exponent a column, the activations' exponents, the rotary tables.

One call replays a served batch teacher-forced: every prompt and the
tokens that were served after it, and returns the logits that predicted
each served token.  It follows the rung as the configuration states it:

* every projection is W8A8: the activation quantized with one
  power-of-two exponent per tensor, the weight with one a column, the
  int8 product exact in int32 (``torch._int_mm``), rescaled once by the
  two exponents; bits=4 gives the control, the same products at int4;
* activations between layers are bf16, norms and softmax f32;
* the SwiGLU is ``silu(g) * u`` in f32 on the products' f32 outputs;
* attention takes the bf16 q, k, v, causal (and windowed where the
  layer has a window), scores and softmax in f32; a prompt's queries
  are scaled and rounded to bf16 and its probabilities rounded to bf16
  for the PV product (the bf16 flash attention of the prefill), a
  decoded row's query is scaled by the bf16 scale; RoPE with float64
  angles;
* an MoE layer routes by the f32 router's softmax, top-k renormalised,
  under the capacity rule C = max(8, ceil8(int(S k / E * factor))) per
  batch row, tokens past C in an expert dropped in token order; the
  contributions are bf16 products of the expert output and its gate,
  summed in f32 in ascending expert order;
* the head is the f32 product of the bf16-rounded last hidden rows and
  head.

The unit of quantization follows the server's steps, worked out again
from the FIFO continuous batching the scheduler documents (``schedule``):
a prompt is one prefill (one exponent over all its rows, one capacity
over its S tokens); the tokens decoded in one tick share one exponent
(the server quantizes a decode pass per tensor over its live lanes; the
lanes without a request are zero and move no exponent), and each is a
batch row of its own for the experts.  So the reference replays whole
served batches: every request of a batch, teacher-forced.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

__all__ = ["ReferenceDecoder", "pow2_exponent", "quantize", "schedule"]


def pow2_exponent(amax: torch.Tensor, bits: int) -> torch.Tensor:
    """``ceil(log2(amax)) - (bits - 1)``, exactly (``frexp``), 0 where
    ``amax`` is 0."""
    m, e = torch.frexp(amax.to(torch.float32))
    ceil_log2 = torch.where(m == 0.5, e - 1, e)
    return torch.where(amax > 0, ceil_log2 - (bits - 1), torch.zeros_like(e)).to(torch.int32)


def quantize(x: torch.Tensor, exp: torch.Tensor, bits: int) -> torch.Tensor:
    """``round(x * 2**-exp)`` (half to even), clipped to the signed range
    of ``bits``, stored as int8; ``exp`` broadcasts against ``x``."""
    lim = 2 ** (bits - 1)
    q = torch.round(x.to(torch.float32) * torch.exp2(-exp.to(torch.float32)))
    return torch.clamp(q, -lim, lim - 1).to(torch.int8)


def _int_product(xq: torch.Tensor, e_row: torch.Tensor, wq: torch.Tensor,
                 e_col: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> f32 (M, N): the exact int32 product,
    then ``acc * 2**(e_row + e_col)``.  Rows are padded to 32 where the
    card's int8 product needs more than 16."""
    m = xq.shape[0]
    pad = 32 - m if m <= 16 else 0
    a = torch.nn.functional.pad(xq, (0, 0, 0, pad)) if pad else xq
    out = torch._int_mm(a.contiguous(), wq)[:m].to(torch.float32)
    # two exact power-of-two scalings, one a row and one a column
    out.mul_(torch.exp2(e_row.to(torch.float32))[:, None])
    return out.mul_(torch.exp2(e_col.to(torch.float32))[None, :])


def _group_exponent(x: torch.Tensor, gid: torch.Tensor, n_groups: int, bits: int) -> torch.Tensor:
    """Per-row exponents of a (M, K) activation whose rows are grouped by
    ``gid`` (M,): one exponent for each group's rows, from its amax."""
    row_amax = x.to(torch.float32).abs().amax(dim=-1)
    amax = torch.zeros((n_groups,), dtype=torch.float32, device=x.device)
    amax = amax.scatter_reduce(0, gid, row_amax, reduce="amax", include_self=True)
    return pow2_exponent(amax, bits)[gid]


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    out = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (out * (1.0 + gain.to(torch.float32))).to(torch.bfloat16)


def _rope_tables(n: int, rope_dim: int, base: float, device,
                 jitter: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """sin and cos of the rotary angles, in float64 then float32.
    ``jitter``: each angle moved by +-``jitter`` radians, the sign drawn
    from a fixed generator (a witness of rounding-sized phase errors)."""
    half = rope_dim // 2
    inv = base ** (-2.0 * torch.arange(half, dtype=torch.float64) / rope_dim)
    ang = torch.arange(n, dtype=torch.float64)[:, None] * inv[None, :]
    if jitter:
        gen = torch.Generator().manual_seed(0x726f7065)
        sign = torch.randint(0, 2, ang.shape, generator=gen).to(torch.float64) * 2 - 1
        ang = ang + jitter * sign
    return (torch.sin(ang).to(torch.float32).to(device), torch.cos(ang).to(torch.float32).to(device))


def _rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x (S, H, D) bf16, half-split convention, in f32, back to bf16."""
    d = x.shape[-1]
    xf = x.to(torch.float32)
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    s, c = sin[:, None, :], cos[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(torch.bfloat16)


class _Quantized:
    """One weight matrix quantized per column: int8 payload and int32
    exponents (N,)."""

    def __init__(self, w: torch.Tensor, bits: int):
        w = w.to(torch.float32)
        self.exp = pow2_exponent(w.abs().amax(dim=0), bits)
        self.q = quantize(w, self.exp[None, :], bits).contiguous()


def schedule(max_new: Sequence[int], n_slots: int) -> List[List[int]]:
    """The decode ticks of one offline batch served by FIFO continuous
    batching over ``n_slots`` lanes: each loop admits pending requests in
    submission order into the free lanes (their prefill gives the first
    token), then one tick decodes every live lane; a request leaves after
    ``max_new`` tokens.  Returns, per request, the tick of each of its
    decode steps (``max_new - 1`` of them)."""
    pending = list(range(len(max_new)))[::-1]
    live: Dict[int, int] = {}                 # request -> tokens so far
    ticks: List[List[int]] = [[] for _ in max_new]
    tick = 0
    while pending or live:
        admitted = []
        while pending and len(live) + len(admitted) < n_slots:
            admitted.append(pending.pop())
        for r in admitted:
            live[r] = 1
            if max_new[r] <= 1:
                del live[r]
        if not live:
            continue
        for r in list(live):
            ticks[r].append(tick)
            live[r] += 1
            if live[r] >= max_new[r]:
                del live[r]
        tick += 1
    return ticks


class _Rows:
    """The rows of one replayed batch: every request's prompt and its
    served tokens but the last, laid end to end."""

    def __init__(self, requests, n_slots: int, device):
        ticks = schedule([len(s) for _, s in requests], n_slots)
        n_req = len(requests)
        tokens, gid, pos, self.segs = [], [], [], []
        for r, (prompt, served) in enumerate(requests):
            seq = list(prompt) + list(served)[:-1]
            self.segs.append((len(tokens), len(prompt), len(seq)))
            tokens += seq
            pos += range(len(seq))
            gid += [r] * len(prompt) + [n_req + t for t in ticks[r]]
        self.tokens = torch.as_tensor(tokens, dtype=torch.long, device=device)
        self.gid = torch.as_tensor(gid, dtype=torch.long, device=device)
        self.pos = torch.as_tensor(pos, dtype=torch.long, device=device)
        self.n_groups = n_req + max((max(t) + 1 for t in ticks if t), default=0)
        self.prompt = self.gid < n_req


class ReferenceDecoder:
    """Teacher-forced reference logits of a decoder configuration.

    ``spec``: the configuration file's numbers (``d_model``, ``n_layers``,
    ``n_heads``, ``n_kv_heads``, ``head_dim``, ``d_ff``, ``vocab``,
    ``rope_base``, ``rms_eps``, ``layer`` and, for sparse experts,
    ``moe``).  ``params``: the float32 weights in the served layout
    (``embed``, ``periods/pos0/{mixer, ffn}`` stacked over layers,
    ``final_norm``, ``lm_head``).  ``bits``: 8 for the rung, 4 for the
    control.  ``rope_jitter``: rotary angles moved by that many radians
    either way (a witness, see ``_rope_tables``; 0 for the reference)."""

    def __init__(self, spec: dict, params: dict, bits: int = 8, head_rows: int = 4096,
                 rope_jitter: float = 0.0):
        self.spec = spec
        self.params = params
        self.bits = bits
        self.rope_jitter = rope_jitter
        self.head_rows = head_rows
        self.eps = float(spec["rms_eps"])
        self.window = spec["layer"].get("window")
        self.moe = spec["layer"]["ffn"] == "moe"

    # -- one layer over all rows ------------------------------------------

    def _proj(self, x: torch.Tensor, rows: _Rows, w: _Quantized) -> torch.Tensor:
        e = _group_exponent(x, rows.gid, rows.n_groups, self.bits)
        return _int_product(quantize(x, e[:, None], self.bits), e, w.q, w.exp)

    def _attention(self, x, rows: _Rows, lw, sin, cos):
        sp = self.spec
        M = x.shape[0]
        H, KV, D = sp["n_heads"], sp["n_kv_heads"], sp["head_dim"]
        h = rms_norm(x, lw["norm"], self.eps)
        q = self._proj(h, rows, lw["wq"]).to(torch.bfloat16).reshape(M, H, D)
        k = self._proj(h, rows, lw["wk"]).to(torch.bfloat16).reshape(M, KV, D)
        v = self._proj(h, rows, lw["wv"]).to(torch.bfloat16).reshape(M, KV, D)
        q, k = _rope(q, sin[rows.pos], cos[rows.pos]), _rope(k, sin[rows.pos], cos[rows.pos])
        # bf16 attention as the rung states it: a prompt's queries scaled in
        # f32 and rounded to bf16, its probabilities rounded to bf16 for the
        # PV product and normalised by their f32 sum; a decoded row's query
        # scaled by the bf16 scale, its softmax and PV in f32
        scale = 1.0 / math.sqrt(D)
        prompt = rows.prompt[:, None, None]
        qs = torch.where(prompt, (q.to(torch.float32) * scale).to(torch.bfloat16),
                         q * torch.tensor(scale, dtype=torch.bfloat16, device=x.device))
        out = torch.empty((M, H, D), dtype=torch.bfloat16, device=x.device)
        G = H // KV
        for s0, _, S in rows.segs:
            sl = slice(s0, s0 + S)
            pos = torch.arange(S, device=x.device)
            keep = pos[None, :] <= pos[:, None]
            if self.window is not None:
                keep = keep & (pos[None, :] > pos[:, None] - self.window)
            bf16_p = rows.prompt[sl][:, None]
            # kv heads in chunks whose f32 scores stay near 512 MB
            step = max(1, min(KV, (1 << 27) // max(1, G * S * S)))
            for k0 in range(0, KV, step):
                k1 = min(KV, k0 + step)
                kf = k[sl, k0:k1].to(torch.float32).transpose(0, 1)[:, None]   # (c, 1, S, D)
                vf = v[sl, k0:k1].to(torch.float32).transpose(0, 1)[:, None]
                qf = qs[sl, k0 * G:k1 * G].to(torch.float32).transpose(0, 1)
                qf = qf.reshape(k1 - k0, G, S, D)                               # (c, G, S, D)
                sc = torch.matmul(qf, kf.transpose(-1, -2))                     # (c, G, S, S)
                sc = sc.masked_fill(~keep, float("-inf"))
                p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
                denom = p.sum(dim=-1, keepdim=True)
                p = torch.where(bf16_p, p.to(torch.bfloat16).to(torch.float32), p)
                o = (torch.matmul(p, vf) / denom).reshape((k1 - k0) * G, S, D).transpose(0, 1)
                out[sl, k0 * G:k1 * G] = o.to(torch.bfloat16)
        return self._proj(out.reshape(M, H * D), rows, lw["wo"]).to(torch.bfloat16)

    def _swiglu(self, h, rows: _Rows, wg, wu, e=None):
        if e is None:
            e = _group_exponent(h, rows.gid, rows.n_groups, self.bits)
        hq = quantize(h, e[:, None], self.bits)
        g = _int_product(hq, e, wg.q, wg.exp)
        u = _int_product(hq, e, wu.q, wu.exp)
        return g * u * torch.sigmoid(g)

    def _mlp(self, x, rows: _Rows, lw):
        h = rms_norm(x, lw["norm"], self.eps)
        act = self._swiglu(h, rows, lw["w_gate"], lw["w_up"]).to(torch.bfloat16)
        return self._proj(act, rows, lw["w_down"]).to(torch.bfloat16)

    def _moe(self, x, rows: _Rows, lw):
        sp = self.spec["moe"]
        E, k, cf = int(sp["num_experts"]), int(sp["top_k"]), float(sp["capacity_factor"])
        M, d = x.shape
        dev = x.device
        h = rms_norm(x, lw["norm"], self.eps)
        logits = torch.matmul(h.to(torch.float32), lw["router"].to(torch.float32))
        probs = torch.softmax(logits, dim=-1)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, experts = vals[:, :k], idx[:, :k]
        gates = gates / gates.sum(dim=-1, keepdim=True)
        # capacity: a prompt is one batch row of S tokens, picks past C in
        # an expert dropped in token order; a decoded token is a batch row
        # of its own (C = 8 >= k: nothing drops)
        keep = torch.ones((M, k), dtype=torch.bool, device=dev)
        for s0, plen, _ in rows.segs:
            cap = max(8, -(-int(plen * k / E * cf) // 8) * 8)
            pe = experts[s0:s0 + plen].reshape(-1)                # token-major picks
            kp = keep[s0:s0 + plen].view(-1)
            for e in range(E):
                hit = (pe == e).nonzero()[:, 0]
                if hit.numel() > cap:
                    kp[hit[cap:]] = False
        tok, pick = keep.nonzero(as_tuple=True)
        ex = experts[tok, pick]
        # the gathered rows: one exponent per group (a prompt; a tick)
        xe = _group_exponent(h[tok], rows.gid[tok], rows.n_groups, self.bits)
        sel = [(ex == e).nonzero()[:, 0] for e in range(E)]
        acts = [self._swiglu(h[tok[s]], rows, lw["w_gate"][e], lw["w_up"][e], xe[s])
                if s.numel() else None for e, s in enumerate(sel)]
        # the hidden activation: one exponent per group over all experts' rows
        amax = torch.zeros((rows.n_groups,), dtype=torch.float32, device=dev)
        for s, a in zip(sel, acts):
            if a is not None:
                amax = amax.scatter_reduce(0, rows.gid[tok[s]], a.abs().amax(dim=-1),
                                           reduce="amax", include_self=True)
        ae = pow2_exponent(amax, self.bits)
        contrib = torch.zeros((M, k, d), dtype=torch.float32, device=dev)
        for e, (s, a) in enumerate(zip(sel, acts)):
            if a is None:
                continue
            e_row = ae[rows.gid[tok[s]]]
            y = _int_product(quantize(a, e_row[:, None], self.bits), e_row,
                             lw["w_down"][e].q, lw["w_down"][e].exp).to(torch.bfloat16)
            g = gates[tok[s], pick[s]].to(torch.bfloat16)
            contrib[tok[s], pick[s]] = (y * g[:, None]).to(torch.float32)
        # a token's picks in ascending expert order, summed from 0 in f32
        order = torch.sort(experts, dim=-1, stable=True).indices
        by_expert = torch.gather(contrib, 1, order[:, :, None].expand_as(contrib))
        y = torch.zeros((M, d), dtype=torch.float32, device=dev)
        for j in range(k):
            y = y + by_expert[:, j]
        return y.to(torch.bfloat16)

    # -- the model -------------------------------------------------------------

    def _layer_weights(self, i: int) -> dict:
        per = self.params["periods"]["pos0"]
        mixer, ffn = per["mixer"], per["ffn"]
        b = self.bits
        lw = {"attn": {"norm": mixer["norm"][i]}}
        for name in ("wq", "wk", "wv", "wo"):
            lw["attn"][name] = _Quantized(mixer[name][i], b)
        f = {"norm": ffn["norm"][i]}
        if self.moe:
            f["router"] = ffn["router"][i]
            E = ffn["w_gate"].shape[1]
            for name in ("w_gate", "w_up", "w_down"):
                f[name] = [_Quantized(ffn[name][i, e], b) for e in range(E)]
        else:
            for name in ("w_gate", "w_up", "w_down"):
                f[name] = _Quantized(ffn[name][i], b)
        lw["ffn"] = f
        return lw

    @torch.no_grad()
    def batch_logits(self, requests: Sequence[Tuple[Sequence[int], Sequence[int]]],
                     n_slots: int) -> List[torch.Tensor]:
        """Replay one served batch: ``requests`` in submission order, each
        (prompt, served tokens), decoded over ``n_slots`` lanes.  Returns,
        per request, the f32 logits (n_served, vocab) of the positions that
        predicted its served tokens (the last prompt position onwards).
        Float32 products run with TF32 off."""
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self._batch_logits(requests, n_slots)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags

    def _batch_logits(self, requests, n_slots):
        sp = self.spec
        dev = self.params["embed"].device
        rows = _Rows(requests, n_slots, dev)
        x = self.params["embed"][rows.tokens].to(torch.bfloat16)
        longest = max(S for _, _, S in rows.segs)
        sin, cos = _rope_tables(longest, sp["head_dim"], float(sp["rope_base"]), dev,
                                self.rope_jitter)
        for i in range(int(sp["n_layers"])):
            lw = self._layer_weights(i)
            x = x + self._attention(x, rows, lw["attn"], sin, cos)
            h = self._moe(x, rows, lw["ffn"]) if self.moe else self._mlp(x, rows, lw["ffn"])
            x = x + h
            del lw, h
        last = torch.cat([torch.arange(s0 + plen - 1, s0 + S, device=dev)
                          for s0, plen, S in rows.segs])
        hidden = rms_norm(x[last], self.params["final_norm"], self.eps)
        head = self.params["lm_head"].to(torch.bfloat16).to(torch.float32)
        out = torch.cat([torch.matmul(hidden[r:r + self.head_rows].to(torch.float32), head)
                         for r in range(0, hidden.shape[0], self.head_rows)])
        return list(torch.split(out, [S - plen + 1 for _, plen, S in rows.segs]))
