#!/usr/bin/env python3
"""Drive the fp8tpu_torch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--phases build,k1,k2,k3,k4,k5,k6,t1,t2,p3,main,
                                    train,train_lm,serve,serve_paged,spec,
                                    moe,flush,time,w8a8,deploy,sparse,
                                    vision,bert,examples,parallel,tp]
    python3 chip_smoke.py --phases build,k2_probe   # not in the default run
    python3 chip_smoke.py --phases build,w8a8_probe # nor these six
    python3 chip_smoke.py --phases build,w8a8k
    python3 chip_smoke.py --phases build,w8a8_time
    python3 chip_smoke.py --phases build,w8a8_p1probe
    python3 chip_smoke.py --phases build,k4_layers
    python3 chip_smoke.py --phases build,profile_probe

Phases, each printing its own lines; any failure exits non-zero:

1. build  nvcc builds every kernel from ``fp8tpu_torch/kernels/csrc``, one
          process per source, in parallel; prints seconds and registers.
2. k1     the cast kernel (K1) against its plain torch version (on the
          CPU), bit-exact,
          over every format x mode x DAZ of the mode-string ABI, scalar /
          per-channel / broadcast / per-block scales, the golden boundary
          vector, f32 subnormals, and SR from explicit bits and from a salt;
          then scalar, per-channel, per-block and SR casts of a tensor
          large enough that each thread of the capped grid loops three
          times; lengths 1, 3, 5, 4k + 1 and 8k + 7, each aligned (the
          16-byte path) and 4 bytes past its allocation (the scalar path),
          and a second launch of each, bit for bit; then every f32 bit
          pattern (2^32, in chunks) through e4m3 and e5m2 RNE at scale 1
          and 448/3.7 and e4m3 SR with a salt, against the plain version
          on the card (NaN inputs, and any non-NaN disagreement, on the
          CPU, which decides).
3. k2     the fused fake-quant GEMM (K2: cast pre-passes and a bf16-split
          GEMM on the tensor cores) at ResNet-50 conv shapes, within the
          f32 summation-order tolerance of the exact product: the PTQ
          path's bitexact variants, the training path's "hw"-RNE
          forward, hw-SR, bitexact-SR and float16-under-"hw" operands,
          the backward's uncast dX and dW GEMMs (dW split over K and
          unsplit, and the two against each other); the engine conv as
          an implicit GEMM at the four convs' geometries, a stride-2 1x1
          downsample and a ragged conv, bitexact and "hw", against the
          exact product of the rebuilt, cast im2col, its scale over the
          gathered positions bit-equal to the im2col's; then each cast
          bit for bit against the plain cast on the CPU, through an
          identity weight.
   k2_probe  (asked for by name) K2's uncast product over K = 100352 of
          terms of one sign at several tensor-core chunk lengths: the
          measurement behind K2's promotion of each chunk into an f32
          sum.
4. k3     the serving dequant-GEMM (K3) against its plain version: e4m3,
          e5m2 and int8 payloads, bf16 and f32 results, decode and prefill
          row counts at the full-width (K, N) of the serving linears and a
          ragged pair (the general kernel), within the summation-order
          bound (plus one bf16 step for bf16 results); every launch of the
          streaming loop, its decode form (M in 1, 8, 9, 16, 17, 63, 64) and
          its prefill route (M in 65, 100, 128, 256, 512, 700, 2048), also
          against the f64 product within the random-walk bound over its
          promoted chunks (stream_reference), and a second launch
          bit-equal; every one of the 256 codes of each payload through
          both forms, value for value against the plain version.
   k4     the paged decode-attention kernel (K4) against its plain
          version at the full-width shapes (8 and 64 slots, 8 KV heads x 4
          query heads of 128, pages of 64 tokens, 8 and 16 pages a slot):
          int8, e4m3, e5m2 and bf16 pools, ragged lengths (0, one token, a
          mid-page end, a full pool), a shuffled page table with unmapped
          (-1) entries, every layer of a 3-layer pool; G in 1, 2, 4, 8 with
          every payload; 1, 8, 33, 64 and 132 slots (across the split
          plan's edges); lengths 0, 1 and a chunk (16), four chunks and a
          page (64), 128 and 512, each +- 1; m bit-equal where the dots are
          exact, l and acc within the stated bound; a second launch
          bit-equal to the first (1, 8, 33, 64 slots); one launch captured
          in a CUDA graph and replayed after the table and the lengths
          changed.
   k5     the int4 unpack-GEMM (K5) likewise, per-channel and group-128
          scales (N = 331 on the general kernel).
   k6     the in-place ring store (K6), bit-exact for 1-, 2- and 4-byte
          types, aligned and unaligned rows, wrapping and negative indices,
          and one launch captured in a CUDA graph and replayed with a
          changed device index; then ring_store (both ring slabs and the
          head's advance in one launch) against ring_store_plain at the
          served ring at 8 and 64 slots, int8 and e4m3, heads 0, n - 1,
          n + 3 and -1, and on a 64 MB row whose blocks run in several
          waves: bytes, head and ticket; and 200 steps captured in one
          CUDA graph and replayed, each with its own slab.
   t1     the convert study T1 through its entry point
          (``fp8tpu_torch.tools.kexp_convert``) at the tool's shapes: 512
          tiles of 512 x 128, 8 reps, the tool's seven modes and the full
          block with the hardware convert, each timed warm (one copy
          re-read) and cold (8 copies); the 256 e4m3 bytes through the
          kernel's converts, bit for bit; each mode's kernel against the
          plain version (fp8 conv modes bit-equal, the rest and every
          tile's fold within the f64 reference's random-walk bound), a
          second launch and the cold copies bit-identical to the first;
          launches counted, no plain version called; the 65536 byte pairs
          through the bits convert at each byte position, and the SASS
          instructions a byte of the three converts (cuobjdump).
   t2     the convert study T2 through ``fp8tpu_torch.tools.
          bench_fp8_linear`` at the tool's shape (64 x 4096 @ 4096 x 11008,
          64 reps): the three e4m3 converts bit-identical and right on all
          256 bytes, every mode against the plain version within K3's
          bound, warm and cold and a second launch bit-identical; then
          every mode at the four serving shapes and the streaming loop's
          row counts as in k3.
   p3     the 8-bit AdamW update (P3) against its plain version, bit
          for bit (the parameter or update, payload bytes, scales), on
          the card and on the CPU, each case's walk and blocks of each
          route counted: 1, 255, 257 and (300, 257) elements, the store
          mode, a zero block, gradients whose squares are f32 subnormals,
          wide gradients, Dense weights through their (in, out) view (the
          tile walk, and a view it does not take), an unaligned leaf;
          blocks forced onto the slow route by their data (NaN or inf g,
          |g| or |p| over the fast route's limits, a subnormal old scale,
          a NaN code) beside fast ones; every leaf of the large decoder
          and a (4096, 11008) leaf on the card, and the decoder's 110
          leaves in one grouped launch; the fast route's divides (the
          bias corrections of counts 1-10, 78 block scales) and its e4m3
          convert over every f32 input, and its divide by every bias
          correction of a b1 0.9 / b2 0.999 run over every significand;
          then its time on that leaf and on
          one step's 110 leaves (one grouped launch, a launch a leaf,
          contiguous), beside the byte bound, the plain version and
          torch.optim.AdamW(fused=True) (f32 moments: another function, a
          yardstick only).  A parent tree's P3 is timed in turns by
          this phase run with --package-tree DIR.
5. main   ResNet-50 (full width, 1000 classes, random weights from a
          seed), batch 32 at 224x224: BN statistics from 2 train-mode
          passes, then quantize_model(e4m3, hw patching, BN folding,
          2 calibration batches, conv1/fc exempt), 1 warm-up and 3 timed
          quantized batches.  Launch counts per forward (52 K2 GEMMs, 104
          K2 pre-passes, 32 K1), logits against
          fp32 (correlation > 0.95), quantized weights bit-equal to the
          CPU path's, and a torch.profiler breakdown of one forward.
   train  FP8 mixed-precision training of ResNet-50 at full width, batch
          32 at 224x224, random weights and data from a seed: the hybrid
          recipe with hw patching, fp16 SR master copy, dynamic loss
          scaling from 2^12, SGD with momentum; 1 warm-up and 4 timed
          steps with K2 launches per step counted (52 "hw" implicit-GEMM
          forward, 104 uncast backward, 260 pre-passes) and no plain
          version called; one step's 156 K2 launches each against the
          exact product of its operands (the conv's rebuilt im2col), its
          conv weight gradients with the kernels against the plain
          versions, the plain pass repeated (bit-identical) and the f32 /
          f64 spread with the casts on and off; a torch.profiler breakdown
          of one step; a forced overflow that must be a true skip.
   train_lm  decoder FP8 training as examples/train_fp8.py runs it
          (hybrid-gemm, fp16 master, emb e4m3, adamw_8bit) at the JAX
          package's large preset (12 layers, d_model 768, 12 / 4 heads,
          d_ff 2304, vocabulary 256; 82.8M parameters, random from a seed),
          batch 32 x 256 tokens of mixed_lm_corpus: 1 warm-up and 4 timed
          steps with P3 (one grouped launch a step over the 110 leaves)
          and K1 (the embedding's requant) launches counted and no plain
          version called; ms/step, tokens/s, peak memory, the optimizer's
          state bytes against AdamW's f32 moments; one step's P3 launch
          with every leaf against the plain version on its own operands; a profile of one step; a forced overflow
          (state and count untouched); the state through a checkpoint on
          disk and back; the same steps with remat (equal losses, peak
          memory); hybrid with hw patching at 2 layers and batch 8 (every
          K2 launch of one step's gradients against k2_reference, the
          loss against K2's plain version).  Each step's count of
          elements with v = 0 and m != 0 (ROADMAP trap 67) and of e4m3
          NaN codes in v; on the checked step each leaf's largest |g|,
          largest v scale and NaN codes before and after its launch.
          train_lm_control (by name): the same steps from the same seed
          with the 8-bit AdamW and with torch.optim.AdamW's f32 moments
          (not the port's path: the control behind trap 67).
6. serve  the serving decoder at full width (16 layers, d_model 4096, 32
          heads / 8 KV heads, d_ff 11008, vocabulary 32768, random e4m3
          weights from a seed, int8 KV ring): (a) a ServingEngine behind an
          EngineServer answers 16 requests of 32 new tokens, twice, with
          K3 / K6 launches per decode step counted (one ring_store a
          step) and no plain version called; (b) 4 decode steps with
          the kernels against the same
          steps with the plain versions on the card; (c) the same server at
          4 layers with int4 weights (K5); (d) timed decode at batch 64 and
          near-full context for e4m3 + int8 KV and for the bf16 twin, with
          a torch.profiler breakdown of one step.
7. serve_paged  the same decoder served from the paged KV pool (int8 pool,
          pages of 64, ``paged_decode_impl="kernel"``): (a) an EngineServer
          over ``ServingEngine(use_paged=True, prefix_cache=True)`` answers
          16 requests whose prompts share a 128-token prefix, twice, with
          K4 / K3 launches per decode step counted, no plain version
          called, the prefix pages shared and every page reclaimed; (b) 4
          decode steps in "kernel" mode against the plain versions and
          against "ringview"; (c) one request whose 900-token context
          exceeds the ring of ``serve``; (d) timed decode at batch 64 for
          "kernel" and "ringview" in turns.
8. spec   draft-and-verify speculation at full width (the target of
          serve; a draft of 2 layers, d_model 512, 8 / 4 heads of 64, d_ff
          2048, random e4m3 weights; k_spec 4): (a) score_tokens_paged at 8
          slots (M = 40, K3's decode form; a padding row, ragged valid
          counts) and 64 (M = 320, the prefill route), T = 5 at position
          444, kernels against plain: logits, the written pool rows, no
          write outside them, K3 launches by route; (b) score_tokens on a
          one-slot ring: kernels against plain (five ring_store launches,
          head, ticket, no stray row) and logits[:, t] against t + 1 decode
          steps; (c) every draft K4 launch of one round (D = 64, G = 2)
          against its plain version within k4_reference's bounds; (d) an
          EngineServer over ServingEngine(paged, prefix cache with compute
          reuse, draft, 4 rounds a dispatch) answers the 16 shared-prefix
          requests with the independent draft (the counted run, with one
          ring speculative_decode) and with a self-draft: tokens equal to
          the plain paged engine's by the margin rule, acceptance printed;
          (e) a scored admission of 8 x 256 tokens against its plain
          version (pool bytes) and the dense prefill (first tokens); (f) one
          dispatch of 4 self-draft rounds at 8 and 64 slots against a paged
          decode chunk of as many tokens: wall clock, kernels, busy share;
          then K3 at M = 40 and 320, K4 at the draft's head shape and K6 on
          the one-slot ring: kernel, plain, bound, PyTorch call.
9. moe    MoE serving at the JAX package's MoE config (vocabulary 32768,
          d_model 2048, 12 layers, 16 / 8 heads of 128, d_ff 5504, 8
          experts, top-2; random e4m3 weights, each expert its own draw,
          int8 KV; nothing cut): (a) every K3 launch of one MoE FFN at M =
          8, 64 and 2048 against plain within K3's bounds; (b) 4 decode
          steps on the ring, the paged pool in "kernel" mode and in
          "ringview" against the plain kernels (logits, the written cache
          bytes, routing flips only at near ties); (c) the same on int4
          experts (K5, grouped scales) on the ring; (d) 16 requests
          through an EngineServer on 8 slots, every token teacher-forced
          inside the margin band of the plain kernels' run; (e) launches:
          K3 12 x (4 + 16) a step, K4 12 a paged step, K6 1 a ring step;
          (f) one timed batch-64 decode step beside the dense serve
          step and the byte bound; then K3 (expert up, M = 8 and 2048),
          K5, K4 at G = 2 and K6 on the MoE ring: kernel, plain, bound,
          PyTorch call.
10. flush batched ring writes (ring_flush = W) at the serve config: K6's
          W-row store against ring_store_plain(rows=W) bit for bit (W 2, 8,
          16; aligned and wrapping starts; guard bytes around the ring
          untouched); a 32-step chunk at batch 64 with ring_flush = 8 (4
          ring_store launches) against the plain kernels and against
          ring_flush = 0 (logits before a slot parts, parting only at near
          ties, the written ring rows); the chunk's time against
          ring_flush = 0; the W-row store's own time.
11. time   each kernel at its main path's shapes: kernel, plain version,
          bound, and a PyTorch yardstick where one exists; K1 bit-exact
          at the largest residual_add operand (device time by CUDA-graph
          replay, and the eager call event-timed) and summed over the 32
          residual-add operands of one forward; K2 as the engine conv at
          four ResNet-50 convs and over all 52 convs of a forward (device
          times by CUDA-graph replay, both bounds: f32 SIMT and the bf16
          MMAs; yardsticks f32 torch.matmul on the cast im2col and f32
          F.conv2d with TF32 off); K2's training variants at the first
          stage's 3x3 conv (forward, dX, dW); K3 and K5 at the serving
          linears, M = 8, 64, 512 and 2048, K4 and K6 at the served shapes,
          the ring write at 8 and 64 slots beside the four launches it
          replaced and an empty kernel's launch;
          one paged prefill of 8 x 256 tokens (2048 rows a linear) with
          e4m3 weights and with the bf16 twin's, wall clock and device
          time, K3's share.

12. w8a8   W8A8 serving (``matmul_impl="direct"``) at full width: (a) P2
          (the per-row activation quantizer) bit for bit against its plain
          version on the CPU: edge rows (zero, bf16 subnormals, +-bf16 max
          and -0, +-inf, NaN, the tiny-amax row, ties) and random rows at
          M in 1-2048 x K in 4096, 11008, 2048, 5504 and a ragged 1001, a
          second launch bit for bit; (b) P1 (the fp8 x fp8 GEMM) at the
          four dense and two expert shapes x 12 row counts, e4m3 and e5m2
          weights, against plain (summation order plus a bf16 step), the
          f64 product over its promotion edges and a second launch, one-sign
          terms over K = 11008, N not a multiple of 128 on both forms,
          every (activation, weight) code pair through both forms; (c)
          P1's f32 sums against cuBLASLt's fp8 GEMM (torch._scaled_mm),
          bit for bit; (d) K3
          with a row scale (int8 direct) on the same checks; (e) decode
          steps at batch 64 on the ring and the paged pool ("kernel"),
          e4m3 and int8 weights: one step with every layer started from
          the plain run's input to it (every layer's written rows >= 0.99
          equal, its output within 5e-2 of its max, e4m3 within
          W8A8_FP8_LAYER_TOL = 7.5e-2 beside cuBLASLt's fp8 GEMM in P1's
          place as a control; each K4 launch on its own operands); 4
          free-running steps, every P2 /
          P1 / K3 launch of the first on its own operands, the logits
          against the drift of an exact-sum plain order (W8A8 is chaotic),
          launches a step; one MoE step with routing flips counted; (f) 16
          requests through the EngineServer twice (equal tokens), every
          token equal to a replay of its admission in the engine's own
          order; then P1, P2, K3 and ``torch._scaled_mm`` timed at M = 8,
          64, 512, 2048 on the gate and k/v projections over 8 weight
          copies, a batch-64 decode step and an 8 x 256 paged prefill,
          convert and direct in turns.
   w8a8_probe  (asked for by name) P1's product over K = 11008 of one-sign
          terms at chunks of 32 to all of K: the measurement behind
          W8A8_PROMOTE; and the bits the fp8 tensor cores keep below a
          step's largest addend, behind W8A8_TC_BITS.  w8a8k (by name):
          (a)-(d) alone.  w8a8_time (by name): the kernel timing alone.
          w8a8_p1probe (by name): P1's time at chunks of 1 to 32 k32
          steps and K = 1024-8192, and a decode step's layers against the
          f32 plain version at each chunk: the measurement behind
          W8A8_PROMOTE's cost.  k4_layers (by
          name): K4 swapped alone between kernel and plain on a paged
          step, and its launches against f64.  profile_probe (by name):
          torch.profiler's device records of the 8 x 256 prefill matched
          to the host's launch calls, without and with the lead-in every
          profile opens with.
13. deploy the deployment path at full width: a float Decoder (f32, 11.9
          GB, random from a seed), 32 x 256 calibration tokens,
          awq_calibrate_decoder (e4m3): the float logits before and after
          the fold, every site no worse than identity; the artifact through
          disk (about 3 GB under chip_smoke_out/, removed) and back, byte
          for byte; an EngineServer with direct linears on it answers 16
          requests, each token equal to the replay in the engine's order;
          then int4 (groups of 128, K5) from memory, held to the band.

14. sparse the sparsity engine at full width (fp8tpu_torch.sparse): (a)
          sparsify_weight at 0.5 on a refresh step on the serve config's
          gate weight (4096 x 11008 f32): the randint draws, the sampled
          threshold and the pruned weight bit-equal to the CPU run, the
          sparsity within 0.01 of 0.5; (b) sparsify_outgrad at 0.5 on an
          (8192, 4096) gradient: the uniform draws bit-equal to the CPU,
          the threshold within SPARSE_THRESHOLD_RTOL of the CPU's, the
          output from a given alpha bit-equal, its mean within 4 standard
          errors of the input's; (c) fake_quant_sparse of the pruned weight
          as a COO tensor (e4m3 RNE none / per-tensor, SR): one K1 launch
          each, values bit-equal to the plain cast on the CPU and to the
          dense fake_quant at the stored positions, indices untouched; (d)
          SparseLinear 4096 -> 11008 on 2048 tokens, forward and backward,
          against f64 within the f32 summation-order bound, the mask
          gradient on the window; (e) K1 against the port's golden and the
          native twin over tests/test_native_ref.py's 16 modes and inputs.
15. vision ViT-B/16 (86M parameters, random from a seed) e4m3 PTQ with hw
          patching and its exempt list at batch 32 x 224^2, nothing cut:
          hw patching reaches none of its modules (Dense and the attention
          einsums are outside the engine, as in the JAX package), so a
          forward is one K1 launch a quantized Dense and no K2; K2 is timed
          and checked at its fc1 shape (6304 x 768 x 3072).  Then the nine
          conv families at their full-width constructors (vgg11,
          mobilenet, inception, densenet, shufflenet, squeezenet,
          mobilenet_v2, mobilenet_v3, efficientnet_b0), batch 8 x 224^2,
          BN statistics from two train passes and folded into the
          scale-shift twin (SqueezeNet is norm-free), calibrated: K2
          launches a forward equal to the non-exempt dense convs of the
          model's table (two pre-passes each), the engine never on a
          grouped conv, every K2 launch of one forward against
          k2_reference, correlation with fp32 > 0.95.
   bert   BERT-base QA (vocabulary 30522, 12 layers at d 768, random from a
          seed at BERT's std 0.02, bert.INIT_STD) at 8 x 384 tokens, hybrid
          PTQ with BERT_QA_EXEMPT and BERT_OUTPUT_FUSED, as
          bert_squad_ptq.py runs it (K1 casts) and
          with hw patching (K2 on each of the 12 x 96 x 2 (batch, head)
          slices of the BatchMatmuls): ms a batch, sequences/s, launches,
          start logits' correlation with fp32 > 0.95, layer 0's 192 K2
          launches against k2_reference, the 48 BatchMatmul casts moved
          from K1 into K2; then K2 timed at a score slice (384 x 64 x 384);
          the control: the casts' correlation of the model drawn at
          1/sqrt(fan_in), printed and not gated.
16. examples  each script of fp8tpu_torch.examples through main(argv) on
          the card in a torch.profiler window: train_fp8 at the large
          preset's width (batch 8 x 256, --opt8 --emb-fmt e4m3, 3 steps:
          one P3 and one K1 launch a step), serve_llm at d_model 4096 / 16
          layers (e4m3 weights, int8 KV, 8 slots, 8 requests of 32 tokens)
          on the ring (K3, K6) and paged with the prefix cache (K3, K4:
          --paged walks the pages), serve_http at its defaults and with
          --paged (two requests over 127.0.0.1 each; K3 with K6, then K4),
          eval_ppl --train 20, resnet_ptq (ResNet-50, 64 images; tiny_vit),
          resnet_qat (4 steps), launch_sweep (tiny_vit, tiny_mobilenet,
          resnet18, e4m3), bert_squad_ptq at its defaults, bert_qa_finetune
          (5 steps): the launches each must make, counted by the wrappers
          and found in the profile, wall seconds and rates.
17. parallel  fp8tpu_torch.parallel over NCCL in a world of one (the card
          holds one H100): tp_mlp_block at the flagship MLP (64 rows, d_model
          4096, d_ff 11008, e4m3 weights, bf16 x, 4 overlap chunks) through
          K3, its five launches counted (1 up, 4 down) with no plain
          version called, each against dequant_matmul_plain within K3's
          bound on its own operands, and a torch.profiler trace's layout of
          the K3 and NCCL kernels by stream; wire_all_reduce_tree (e4m3)
          over a gradient tree of the train_lm preset's 110 leaves (82.8M
          elements), bit-equal to the same call on the CPU over gloo, timed;
          the train_lm trainer's data-parallel step (BatchShard, the loss
          as the global batch's share) for train_lm's 5 steps, parameters
          bit-equal to the non-parallel step's, K1 and P3 launches counted;
          pipeline_apply at one stage (a 4096-wide quantized stage, K1
          casts, 4 microbatches) and moe_ffn over a one-rank mesh, outputs
          and gradients bit-equal to the plain composition and to
          mesh=None; then K3 at the TP shapes: kernel, plain, bound,
          PyTorch call.
18. tp    tensor parallelism inside the decoder over NCCL in a world of
          one, at bench.py's CFG width (16 layers, d_model 4096, 32 / 8
          heads, d_ff 11008, vocabulary 32768): (a) quantized_apply(mesh=)
          of the emulation Decoder's TP form (e4m3 PTQ, bf16, 2.95 B
          parameters from a seed, 4 x 128 tokens) on a data 1 x model 1
          mesh, its K1 launches counted with no plain cast, its weights
          bit-equal to the unsharded quantize_params, its logits within
          2e-3 of max|logit| of the unsharded forward, K1 at the path's
          largest shape (the embedding's per-row cast) bit for bit against
          the plain version (on the card; its first 2048 rows on the CPU),
          both forwards' wall and device ms; (b) the ring engine behind an
          EngineServer and the self-draft paged engine (K4's page walk)
          over the mesh, tokens equal to the unsharded engines', one
          sharded decode step's K3 launches within K3's bounds
          (gemm_tolerance, stream_reference), its K6 ring write bit-equal
          to ring_store_plain, one paged step's K4 launches within
          k4_reference's, a decode step's wall and device ms beside the
          unsharded one's; (c) K3 at the model-4 and model-8 shard shapes
          of q / gate (column, bf16 out) and o / down (row, f32 out) and
          K4 on KV / 4 and KV / 8 heads, against their plain versions and
          timed beside the unsharded launches.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Details go to the JSON
file that ``--out`` names (default ``chip_smoke_out/chip_smoke.json``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

BATCH = 32                     # images per batch on the main path
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_SIMT_FLOPS = 67e12         # H100 SXM f32 outside the tensor cores
BF16_TC_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core rate

BOUNDARY = [
    0.0, -0.0, 1.0, -1.0, 57344.0, -57344.0, 61440.0, -61440.0,
    65504.0, -65504.0, 448.0, -448.0, 480.0, -480.0, 449.0,
    240.0, -240.0, 30.0, -30.0, 31.0, -31.0, 2.0 ** -16, -(2.0 ** -16),
    2.0 ** -9, 2.0 ** -6, 2.0 ** -2, 1.5e-5, 1.9e-3, 1.5e-2,
    0.1, -0.1, 3.14159, -2.71828, 1e6, -1e6, 1e-8, -1e-8,
    float("inf"), float("-inf"), float("nan"),
]
SUBNORMALS = [1e-40, -1e-40, 1e-39, -3e-39, 1.1e-38, 2.0 ** -149]

MODE_STRINGS = (
    [f"E5M2_{m}" for m in ("RTZ", "STOCHASTIC", "RNE", "RNAZ", "RNTZ",
                           "RPINF", "RNINF")]
    + [f"E5M2_DAZ_{m}" for m in ("STOCHASTIC", "RNE", "RNAZ", "RNTZ",
                                 "RPINF", "RNINF", "RTZ")]
    + [f"{f}_{m}" for f in ("E4M3", "E4M3_IEEE", "E3M4")
       for m in ("RNE", "STOCHASTIC", "RNAZ", "RNTZ", "RPINF", "RNINF",
                 "RTZ")]
    + [f"E4M3_V2_{m}" for m in ("RNE", "STOCHASTIC", "RNAZ", "RNTZ",
                                "RPINF", "RNINF", "RTZ")]
    + ["FP4_NEAREST", "BFLOAT16_RNE", "BFLOAT16_STOCHASTIC", "FLOAT16_RNE",
       "FLOAT16_STOCHASTIC", "FLOAT16_DAZ_RNE", "E5M2_NOINF_RNE",
       "E5M2_FLEX_RNE"]
)

def resnet50_convs(batch: int):
    """The 52 patched convs of one ResNet-50 forward (the stem conv is
    exempt), in order: (batch, Cin, H = W, Cout, kernel, stride, pad)."""
    convs, in_f, hw = [], 64, 56
    for stage, (blocks, f) in enumerate(zip((3, 4, 6, 3),
                                            (64, 128, 256, 512))):
        for b in range(blocks):
            s = 2 if stage > 0 and b == 0 else 1
            convs += [(batch, in_f, hw, f, 1, 1, 0),
                      (batch, f, hw, f, 3, s, 1),
                      (batch, f, hw // s, 4 * f, 1, 1, 0)]
            if b == 0:
                convs.append((batch, in_f, hw, 4 * f, 1, s, 0))
            in_f, hw = 4 * f, hw // s
    return convs


def conv_gemm(conv):
    """(M, K, N) of a conv's im2col GEMM."""
    b, cin, h, cout, k, s, p = conv
    out = (h + 2 * p - k) // s + 1
    return b * out * out, cin * k * k, cout


def resnet50_conv_gemms(batch: int):
    """(M, K, N) of the 52 patched convs of one ResNet-50 forward."""
    return [conv_gemm(c) for c in resnet50_convs(batch)]


# Representative ResNet-50 convs (batch 32): (name, conv), and their GEMMs
# (name, M, K, N).
K2_CONVS = [
    ("stage0 3x3", (BATCH, 64, 56, 64, 3, 1, 1)),
    ("stage0 1x1 expand", (BATCH, 64, 56, 256, 1, 1, 0)),
    ("stage3 1x1", (BATCH, 2048, 7, 512, 1, 1, 0)),
    ("stage3 3x3", (BATCH, 512, 7, 512, 3, 1, 1)),
]
K2_SHAPES = [(name, *conv_gemm(conv)) for name, conv in K2_CONVS]
# Further conv geometries for the k2 phase: the stride-2 1x1 downsample
# (it gathers every other row and column) and a ragged conv (channels not
# a multiple of 8, odd size, stride 2).
K2_MORE_CONVS = [
    ("stage1 1x1 stride-2 downsample", (BATCH, 256, 56, 512, 1, 2, 0)),
    ("ragged", (3, 20, 11, 37, 3, 2, 1)),
]


class PhaseError(Exception):
    pass


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bits_equal(a, b) -> int:
    """Number of elements whose f32 bit patterns differ."""
    import torch
    a = a.to(torch.float32).contiguous().view(torch.int32)
    b = b.to(torch.float32).contiguous().view(torch.int32)
    return int((a != b).sum())


# -- phase 1 ----------------------------------------------------------------

def phase_build(record):
    from fp8tpu_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build_all()
    seconds = time.perf_counter() - t0
    for name, r in report.items():
        lines = r["log"].splitlines()
        regs = [ln.strip() for ln in lines
                if "registers" in ln or "spill" in ln]
        print(f"build {name}: {r['seconds']:.1f} s")
        for ln in regs[:4]:
            print(f"  ptxas {ln}")
        # ptxas draining the wgmmas itself (C7517) costs the loop its
        # overlap: show it
        for ln in [ln.strip() for ln in lines if "C7517" in ln][:4]:
            print(f"  ptxas {ln}")
        record.setdefault("build", {})[name] = r
        if name == "dequant_matmul":
            # W8A8's int8 route: every instance's registers and spills
            for fn, regs_, spills in ptxas_entries(r["log"]):
                if "Int8" in fn or "S8<2>" in fn:
                    print(f"  ptxas int8 route: {regs_} registers, {spills} "
                          f"bytes of spill stores: {fn[:150]}")
    print(f"build: all kernels ready in {seconds:.1f} s")


def ptxas_entries(log):
    """[(kernel, registers, bytes of spill stores)] from ``nvcc -Xptxas
    -v``'s log, names demangled where c++filt is found."""
    import re
    import shutil
    out, fn, spill = [], None, 0
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn is not None:
            out.append((fn, int(m.group(1)), spill))
            fn = None
    filt = shutil.which("c++filt")
    if filt and out:
        names = subprocess.run([filt], input="\n".join(f for f, _, _ in out),
                               capture_output=True, text=True).stdout
        out = [(n, r, s) for n, (_, r, s) in zip(names.splitlines(), out)]
    return out


# -- phase 2 ----------------------------------------------------------------

def phase_k1(record):
    import numpy as np
    import torch
    from fp8tpu_torch.kernels import cast_kernel
    from fp8tpu_torch.numerics.cast import qdq_plain
    from fp8tpu_torch.numerics.formats import parse_mode_string, RoundMode

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rand = (rng.standard_normal(4096)
            * np.exp(rng.uniform(-25, 15, 4096))).astype(np.float32)
    x = torch.from_numpy(np.concatenate([
        np.array(BOUNDARY + SUBNORMALS, np.float32), rand])).to(dev)
    rb = torch.from_numpy(rng.integers(0, 65536, x.shape).astype(np.int32)
                          ).to(dev)

    def variant(ms):
        ml = ms.lower()
        if ml in ("e5m2_noinf_rne", "e5m2_flex_rne"):
            return ml[:-4], RoundMode.RNE, False
        if ml.startswith("e4m3_v2_"):
            return "e4m3_v2", RoundMode[ml[8:].upper()], False
        fmt, mode, daz = parse_mode_string(ms)
        return fmt.name, mode, daz

    cases = mismatches = 0
    failures = []

    def check(label, xx, fmt, mode, daz, **kw):
        # The plain version runs on the CPU: it is the one the tests hold
        # against the JAX package, NaN payloads included.
        nonlocal cases, mismatches
        got = cast_kernel.cuda_qdq(xx, fmt, mode, daz=daz, **kw)
        want = qdq_plain(xx.cpu(), fmt, mode, daz=daz,
                         **{k: v.cpu() if torch.is_tensor(v) else v
                            for k, v in kw.items()})
        got = got.cpu()
        bad = bits_equal(got, want)
        cases += 1
        if bad:
            mismatches += bad
            failures.append(f"{label}: {bad} elements differ")

    for ms in MODE_STRINGS:
        fmt, mode, daz = variant(ms)
        sr = mode == RoundMode.STOCHASTIC
        bits = [dict(random_bits=rb), dict(salt=0x9E3779B9)] if sr \
            else [dict()]
        for scale in (1.0, 3.7, 1e-3, 6.55e4, 1e36):
            for b in bits:
                check(f"{ms} scale={scale} {list(b)}", x, fmt, mode, daz,
                      scale=torch.tensor(scale, device=dev), **b)
        x2 = x[:4096].reshape(16, 16, 16)
        per_axis = {
            "axis0": torch.linspace(0.5, 40.0, 16, device=dev).reshape(16, 1, 1),
            "axis1": torch.linspace(0.5, 40.0, 16, device=dev).reshape(1, 16, 1),
            "axis2": torch.linspace(0.5, 40.0, 16, device=dev),
            "axes0,2": torch.linspace(0.5, 40.0, 256, device=dev).reshape(16, 1, 16),
        }
        for label, s in per_axis.items():
            check(f"{ms} {label}", x2, fmt, mode, daz, scale=s,
                  **({"salt": 7} if sr else {}))
        if fmt in ("e5m2", "e4m3", "e4m3_ieee", "e3m4", "fp4"):
            for bs in (128, 32, 100):
                for b in bits:
                    check(f"{ms} block={bs} {list(b)}", x[:4000], fmt, mode,
                          daz, block_size=bs,
                          **({k: (v[:4000] if torch.is_tensor(v) else v)
                              for k, v in b.items()}))

    # Past the grid's cap of 64 blocks of 256 threads per SM, so that every
    # thread's grid-stride loop (and every warp's block loop) takes three
    # passes.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_big = 3 * 64 * 256 * sms
    g = torch.Generator(device=dev).manual_seed(3)
    big = torch.randn(n_big // 256, 256, device=dev, generator=g) * torch.exp(
        torch.empty(n_big // 256, 256, device=dev).uniform_(-20, 12,
                                                             generator=g))
    big_rb = torch.randint(0, 65536, big.shape, device=dev, generator=g,
                           dtype=torch.int32)
    s37 = torch.tensor(3.7, device=dev)
    for label, fmt, mode, kw in (
            ("scalar", "e4m3", RoundMode.RNE, dict(scale=s37)),
            ("scalar SR bits", "e4m3", RoundMode.STOCHASTIC,
             dict(scale=s37, random_bits=big_rb)),
            ("scalar SR salt", "e5m2", RoundMode.STOCHASTIC,
             dict(scale=s37, salt=0x9E3779B9)),
            ("per-channel", "e4m3", RoundMode.RNE,
             dict(scale=torch.linspace(0.5, 40.0, 256, device=dev))),
            ("block=32", "e4m3", RoundMode.RNE, dict(block_size=32))):
        check(f"{n_big} elements {fmt} {label}", big, fmt, mode, False, **kw)
    # Lengths around the 16-byte path's groups (n % 4 is the scalar tail), a
    # view whose data starts 4 bytes past an allocation (the scalar path),
    # and a second launch of each: the same bits.
    vec_paths = {}
    repeat_bad = 0
    for n in K1_LENGTHS:
        for off in (0, 1):
            xs = big.reshape(-1)[:n + off][off:]
            rbs = big_rb.reshape(-1)[:n + off][off:]
            vec_paths[(n, off)] = cast_kernel.vector_path(
                n, (xs.data_ptr(), rbs.data_ptr()))
            for label, fmt, mode, kw in (
                    ("e4m3 RNE", "e4m3", RoundMode.RNE, dict(scale=s37)),
                    ("e4m3 SR bits", "e4m3", RoundMode.STOCHASTIC,
                     dict(scale=s37, random_bits=rbs)),
                    ("e5m2 SR salt", "e5m2", RoundMode.STOCHASTIC,
                     dict(scale=s37, salt=0x9E3779B9)),
                    ("e4m3 per-channel", "e4m3", RoundMode.RNE,
                     dict(scale=torch.linspace(0.5, 40.0, n, device=dev)))):
                check(f"n={n} offset={4 * off} B {label}", xs, fmt, mode,
                      False, **kw)
                a = cast_kernel.cuda_qdq(xs, fmt, mode, **kw)
                b = cast_kernel.cuda_qdq(xs, fmt, mode, **kw)
                repeat_bad += bits_equal(a, b)
    if not any(vec_paths[(n, 0)] for n in K1_LENGTHS) \
            or any(vec_paths[(n, 1)] for n in K1_LENGTHS):
        failures.append(f"the 16-byte path was not chosen as expected: "
                        f"{vec_paths}")
    if repeat_bad:
        failures.append(f"a second launch changed {repeat_bad} elements")
    sweep = k1_sweep(cast_kernel, qdq_plain, RoundMode)
    failures += sweep.pop("failures")
    record["k1"] = {"cases": cases, "mismatched_elements": mismatches,
                    "repeat_mismatches": repeat_bad, "sweep": sweep,
                    "failures": failures[:50]}
    print(f"k1: {cases} cases over {len(MODE_STRINGS)} mode strings and "
          f"lengths {K1_LENGTHS} (aligned and 4 bytes past an allocation), "
          f"{mismatches} mismatched elements (bit-exact required); second "
          f"launches: {repeat_bad} elements changed; every f32 bit pattern "
          f"through {len(sweep['variants'])} variants: "
          f"{sweep['kernel_mismatches']} mismatches, card plain vs CPU on "
          f"{sweep['plain_card_vs_cpu']} non-NaN elements (the CPU decides)")
    if failures:
        for f in failures[:10]:
            print(f"  k1 FAIL {f}")
        raise PhaseError("K1 disagrees with its plain version")


K1_LENGTHS = (1, 3, 5, 4 * 1001 + 1, 8 * 1001 + 7, 4 * 300007 + 1)
K1_SWEEP_CHUNK = 1 << 26


def k1_sweep(cast_kernel, qdq_plain, RoundMode):
    """Every f32 bit pattern, 2^32 in chunks, through K1 for e4m3 and e5m2
    RNE at scale 1 and at a calibrated scale that is not a power of two,
    and e4m3 SR with a salt, against the plain version on the card.  A
    non-NaN element where the two differ is computed again by the plain
    version on the CPU, which decides; NaN inputs are checked on the CPU
    only (the card's NaN payloads differ from the host's)."""
    import torch
    from fp8tpu_torch.numerics.cast import sr_bits_from_salt
    dev = torch.device("cuda")
    cal = torch.tensor(448.0 / 3.7, device=dev)
    one = torch.tensor(1.0, device=dev)
    salt = 0x9E3779B9
    variants = [("e4m3 RNE scale 1", "e4m3", RoundMode.RNE, one, None),
                ("e4m3 RNE scale 448/3.7", "e4m3", RoundMode.RNE, cal, None),
                ("e5m2 RNE scale 1", "e5m2", RoundMode.RNE, one, None),
                ("e5m2 RNE scale 448/3.7", "e5m2", RoundMode.RNE, cal, None),
                ("e4m3 SR salt, scale 448/3.7", "e4m3",
                 RoundMode.STOCHASTIC, cal, salt)]
    out = {"variants": [v[0] for v in variants], "kernel_mismatches": 0,
           "plain_card_vs_cpu": 0, "nan_inputs_checked": 0, "failures": []}
    sr_cpu = sr_bits_from_salt(salt, K1_SWEEP_CHUNK)
    for start in range(0, 1 << 32, K1_SWEEP_CHUNK):
        u = torch.arange(start, start + K1_SWEEP_CHUNK, device=dev,
                         dtype=torch.int64)
        x = torch.where(u >= 1 << 31, u - (1 << 32), u).to(
            torch.int32).view(torch.float32)
        del u
        nan = torch.isnan(x)
        for label, fmt, mode, scale, sl in variants:
            got = cast_kernel.cuda_qdq(x, fmt, mode, scale, salt=sl)
            want = qdq_plain(x, fmt, mode, scale, salt=sl)
            diff = (got.view(torch.int32) != want.view(torch.int32)) & ~nan
            recheck = diff | nan
            idx = recheck.nonzero().reshape(-1)
            if idx.numel():
                ic = idx.cpu()
                kw = ({"random_bits": sr_cpu[ic]} if sl is not None else {})
                cpu = qdq_plain(x[idx].cpu(), fmt, mode, scale.cpu(), **kw)
                gi = got[idx].cpu().view(torch.int32)
                wi = want[idx].cpu().view(torch.int32)
                bad = int((gi != cpu.view(torch.int32)).sum())
                out["plain_card_vs_cpu"] += int(
                    ((wi != cpu.view(torch.int32)) & ~nan[idx].cpu()).sum())
                out["nan_inputs_checked"] += int(nan[idx].sum())
                if bad:
                    out["kernel_mismatches"] += bad
                    first = int(ic[(gi != cpu.view(torch.int32))][0])
                    out["failures"].append(
                        f"sweep {label}: {bad} elements of chunk "
                        f"{start:#x} differ, first input bits "
                        f"{start + first:#010x}")
            del got, want, diff, recheck
        del x, nan
    return out


# -- phase 3 ----------------------------------------------------------------

# K2 against the exact product of its cast operands: a length-K f32 sum
# rounds at every add, by at most 2^-24 of the partial sum and by a random
# sign, so its error grows like 2^-24 * sqrt(sum_j S_j^2) over the partial
# sums S_j, not like the worst case K * 2^-24 * sum|x w|, which at K = 100352
# exceeds a typical output and lets a dropped split pass.  The partial sums
# are taken at K2_BLOCKS block ends of the exact product, each widened by its
# block's spread sqrt(sum (x w)^2).  K2_ORDER_C times that estimate is the
# tolerance: sound runs on the H100 read errors of at most 3.8 estimates
# (the kernel and cuBLAS alike, PERF.md), a dW launch with one split left
# out of its merge 7e4 to 6e5.
K2_ORDER_C = 16.0
K2_BLOCKS = 16


def k2_reference(xq, wq, edges=None):
    """(exact, tol): the f64 product of K2's cast operands, and the
    largest |f32 result - exact| allowed for any order of the f32 sums,
    elementwise (see K2_ORDER_C).  ``edges``: the K rows where the partial
    sums are taken (default K2_BLOCKS equal blocks); the streaming loop
    passes its promoted chunks."""
    import torch
    k = xq.shape[1]
    if edges is None:
        nb = min(K2_BLOCKS, k)
        edges = [k * i // nb for i in range(nb + 1)]
    x, w = xq.double(), wq.double()
    exact = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float64,
                        device=x.device)
    walk = torch.zeros_like(exact)
    for a, b in zip(edges, edges[1:]):
        before = exact.abs()
        exact = exact + x[:, a:b] @ w[a:b]
        spread = (x[:, a:b].square() @ w[a:b].square()).sqrt()
        walk += (b - a) * (torch.maximum(before, exact.abs()) + spread
                           ).square()
    tol = K2_ORDER_C * 2.0 ** -24 * walk.sqrt() + k * 2.0 ** -149
    return exact, tol


def k2_ratio(out, exact, tol) -> float:
    """max |out - exact| / tol; inf where out is not finite."""
    import torch
    if not bool(torch.isfinite(out).all()):
        return math.inf
    return float(((out.double() - exact).abs() / tol).max())


def k2_row(label, m, k, n, got, want, exact, tol):
    """One K2 case: the kernel within the tolerance of the exact product
    (the plain version's distance is recorded beside it)."""
    ratio, plain_ratio = k2_ratio(got, exact, tol), k2_ratio(want, exact, tol)
    err = float((got - want).abs().max())
    ok = ratio <= 1.0
    print(f"k2 {label} M={m} K={k} N={n}: |kernel - plain| {err:.3e}; "
          f"|err| / tolerance: kernel {ratio:.3e}, plain {plain_ratio:.3e} "
          f"-> {'ok' if ok else 'FAIL'}")
    return {"case": label, "m": m, "k": k, "n": n, "max_abs_err": err,
            "err_over_tol": ratio, "plain_err_over_tol": plain_ratio,
            "ok": ok}


def phase_k2(record):
    import torch
    from fp8tpu_torch.kernels import qmatmul
    from fp8tpu_torch.numerics.cast import cast_array
    from fp8tpu_torch.numerics.formats import RoundMode

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    # The main path's variants at its shapes, then the runtime-selected
    # variants (any other format pair) at a ragged shape.
    variants = [("e4m3", None), ("e4m3", "e4m3")]
    cases = [(s, fx, fw) for s in K2_SHAPES for fx, fw in variants]
    cases += [(("ragged", 1000, 100, 70), fx, fw) for fx, fw in
              variants + [("e5m2", None), ("e3m4", "e3m4"), ("fp4", "e4m3"),
                          ("bfloat16", "float16"), (None, "e5m2"),
                          (None, None)]]
    rne = RoundMode.RNE
    for (name, m, k, n), fmt_x, fmt_w in cases:
        x = torch.randn(m, k, device="cuda", generator=gen).relu_()
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        sx = 0.5 / x.abs().amax() if fmt_x == "fp4" else 448.0 / x.abs().amax()
        sw = 448.0 / w.abs().amax(0)
        got = qmatmul.qdq_matmul(x, w, fmt_x, rne, fmt_w, rne, sx, sw)
        want = qmatmul.plain(x, w, fmt_x, rne, fmt_w, rne, sx, sw)
        xq = x if fmt_x is None else cast_array(x, sx, None, fmt_x, rne)
        wq = w if fmt_w is None else cast_array(w, sw.reshape(1, -1), None,
                                                fmt_w, rne)
        rows.append(k2_row(f"{name} x={fmt_x} w={fmt_w}", m, k, n, got,
                           want, *k2_reference(xq, wq)))
    rows += k2_training_cases(gen)
    rows += [k2_conv_case(gen, name, conv, impl)
             for name, conv in K2_CONVS + K2_MORE_CONVS
             for impl in ("bitexact", "hw")]
    identity = k2_identity_casts()
    record["k2"] = {"cases": rows, "identity_casts": identity}
    print(f"k2: worst kernel |err| / tolerance {max(r['err_over_tol'] for r in rows):.3e} over "
          f"{len(rows)} cases (C = {K2_ORDER_C}); the plain version's "
          f"{max(r['plain_err_over_tol'] for r in rows):.3e}")
    if not all(r["ok"] for r in rows):
        raise PhaseError("K2 is farther from the exact product than the "
                         "summation-order tolerance")
    if not all(r["ok"] for r in identity):
        raise PhaseError("K2's in-kernel casts differ from the plain casts")


def conv_rows(out):
    """An NCHW conv output as the (pixels, channels) rows of its GEMM."""
    return out.permute(0, 2, 3, 1).reshape(-1, out.shape[1])


def k2_conv_operands(x, weight, strides, pads, fmt, mode, scale, seed=0,
                     impl="bitexact"):
    """The two operands of a conv's GEMM as the plain version makes them:
    the cast im2col, rebuilt from x, and the (Cin*KH*KW, Cout) weight."""
    from fp8tpu_torch.kernels import qmatmul
    col = qmatmul.im2col(x, tuple(weight.shape[2:]), strides, pads)[0]
    if fmt is not None:
        col = qmatmul.cast_operand(col, fmt, mode, scale, impl,
                                   qmatmul.sr_key(seed, 1, fmt, mode))
    return col, weight.float().reshape(weight.shape[0], -1).t()


def k2_conv_case(gen, name, conv, impl, fmt="e4m3"):
    """The engine conv through K2's implicit GEMM (qmatmul.conv) within the
    summation-order tolerance of the exact product of the cast im2col and
    the weight, with the scale taken over the gathered positions bit-equal
    to per_tensor of the im2col."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    from fp8tpu_torch.numerics.formats import RoundMode
    from fp8tpu_torch.numerics.scaling import per_tensor
    b, cin, h, cout, k, s, p = conv
    x = torch.randn(b, cin, h, h, device="cuda", generator=gen).relu_()
    w = torch.randn(cout, cin, k, k, device="cuda",
                    generator=gen) / (cin * k * k) ** 0.5
    strides, pads = (s, s), ((p, p), (p, p))
    scale = per_tensor(qmatmul.gathered(x, (k, k), strides, pads), fmt)
    col = qmatmul.im2col(x, (k, k), strides, pads)[0]
    scale_bits = bits_equal(scale, per_tensor(col, fmt))
    del col
    args = (x, w, strides, pads, fmt, RoundMode.RNE, scale, 0, impl)
    got = conv_rows(qmatmul.conv(*args))
    want = conv_rows(qmatmul.conv_plain(*args))
    exact, tol = k2_reference(*k2_conv_operands(*args))
    m, kk, n = conv_gemm(conv)
    row = k2_row(f"conv {name} {impl} x={fmt} (implicit GEMM)", m, kk, n,
                 got, want, exact, tol)
    row["scale_bits_differ"] = scale_bits
    if scale_bits:
        print(f"k2 conv {name}: the gathered scale differs from "
              "per_tensor(im2col) -> FAIL")
        row["ok"] = False
    return row


# The accumulation probe: the tensor cores' f32 accumulation is not IEEE
# round to nearest, so K2 sums each k-chunk on them and adds the chunk into
# an f32 accumulator with ordinary adds.  Long sums of terms of one sign
# are where a directed rounding shows: the probe runs K2's uncast product
# over K = 100352 (the length of the backward's weight gradient at
# ResNet-50's first stage) at several chunk lengths, 0 meaning one chunk.
PROBE_PROMOTE = (0, 64, 16, 4, 1)


def phase_k2_probe(record):
    import torch
    from fp8tpu_torch.kernels import qmatmul
    from fp8tpu_torch.numerics.formats import RoundMode
    gen = torch.Generator(device="cuda").manual_seed(7)
    m, k, n = 256, 100352, 64
    x = torch.rand(m, k, device="cuda", generator=gen) + 0.5
    w = torch.rand(k, n, device="cuda", generator=gen) + 0.5
    exact, tol = k2_reference(x, w)
    rows = []
    for promote in PROBE_PROMOTE:
        got = qmatmul._launch(x, w, None, RoundMode.RNE, None, RoundMode.RNE,
                              1.0, 1.0, unsplit=True, promote=promote)
        rel = (got.double() - exact) / exact
        rows.append({"promote_slabs": promote,
                     "chunk": promote * qmatmul.K2_BK if promote else k,
                     "err_over_tol": k2_ratio(got, exact, tol),
                     "mean_rel_err": float(rel.mean()),
                     "max_abs_rel_err": float(rel.abs().max())})
        print(f"k2_probe chunk {rows[-1]['chunk']} (M={m} K={k} N={n}, "
              f"terms in [0.25, 2.25)): |err| / tolerance "
              f"{rows[-1]['err_over_tol']:.3e}, mean relative error "
              f"{rows[-1]['mean_rel_err']:.3e}")
    record["k2_probe"] = {"rows": rows, "k2_promote": qmatmul.K2_PROMOTE}
    used = [r for r in rows if r["promote_slabs"] == qmatmul.K2_PROMOTE]
    if not used or used[0]["err_over_tol"] > 1.0:
        raise PhaseError("K2's chunk length does not keep the long sum "
                         "within the tolerance")


# ResNet-50's first stage (56x56, stage0 in the module names), 3x3 conv at
# batch 32: the forward GEMM and the backward's two (g is (M, 64)).
K2_TRAIN_SHAPES = {
    "forward": (BATCH * 56 * 56, 64 * 9, 64),
    "dX": (BATCH * 56 * 56, 64, 64 * 9),
    "dW": (64 * 9, BATCH * 56 * 56, 64),
}


def k2_training_cases(gen):
    """The training path's K2 variants within the summation-order
    tolerance of the exact product: hw-RNE e4m3 / e5m2 / bf16 activations
    at the forward shape, hw-SR and bitexact-SR operands and float16 under
    "hw" (the bit pipeline) at a ragged shape, and the backward's uncast
    GEMMs at the dX and dW shapes; dW split over K and unsplit, and the two
    within the same tolerance of each other."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    from fp8tpu_torch.numerics.formats import RoundMode
    rne, sr = RoundMode.RNE, RoundMode.STOCHASTIC
    fwd, dx, dw = (K2_TRAIN_SHAPES[k] for k in ("forward", "dX", "dW"))
    ragged = (1000, 100, 70)
    cases = [(fwd, "hw", f, rne, None, rne) for f in ("e4m3", "e5m2",
                                                       "bfloat16")]
    cases += [(ragged, "hw", f, sr, fw, mw)
              for f in ("e4m3", "e5m2", "bfloat16")
              for fw, mw in ((None, rne), (f, sr))]
    cases += [(ragged, "hw", "float16", rne, "float16", sr),
              (ragged, "bitexact", "e4m3", sr, "e5m2", sr),
              (dx, "bitexact", None, rne, None, rne),
              (dw, "bitexact", None, rne, None, rne)]
    rows = []
    for (m, k, n), impl, fmt_x, mode_x, fmt_w, mode_w in cases:
        x = torch.randn(m, k, device="cuda", generator=gen) * 2.0
        if (m, k, n) == dw:
            x.relu_()             # dW's rows are activations, mostly >= 0
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        sx = 448.0 / x.abs().amax()
        sw = 448.0 / w.abs().amax(0)
        args = (x, w, fmt_x, mode_x, fmt_w, mode_w, sx, sw, 77)
        label = f"train {impl} x={fmt_x}/{mode_x.name} w={fmt_w}/{mode_w.name}"
        want = qmatmul.plain(*args, impl=impl)
        exact, tol = k2_reference(*k2_operands(*args, impl))
        got = qmatmul._launch(*args, impl=impl)
        rows.append(k2_row(label, m, k, n, got, want, exact, tol))
        if (m, k, n) == dw:
            whole = qmatmul._launch(*args, impl=impl, unsplit=True)
            rows.append(k2_row(label + " unsplit", m, k, n, whole, want,
                               exact, tol))
            rows.append(k2_row(label + " split vs unsplit", m, k, n, got,
                               want, whole.double(), tol))
    return rows


def k2_identity_casts():
    """K2's in-kernel casts bit for bit: ``qdq_matmul(x, I, fmt_w=None)``
    makes each output one exact product x_q * 1 plus exact zeros, so K2
    must return the plain cast of x on the CPU (with -0 read as +0).  Rows
    cover normals, each format's subnormals, f32 subnormals, saturation
    and overflow; a row whose cast holds inf or NaN must come back all NaN
    (inf * 0 and NaN * 0 enter every output of the row)."""
    import numpy as np
    import torch
    from fp8tpu_torch.kernels import qmatmul
    from fp8tpu_torch.numerics.formats import RoundMode
    rne, sr = RoundMode.RNE, RoundMode.STOCHASTIC
    rng = np.random.default_rng(3)
    k = 128
    small = [v for v in BOUNDARY if np.isfinite(v) and abs(v) < 1e4] \
        + SUBNORMALS + [2.0 ** -126, 2.0 ** -130, 2.0 ** -10, 3 * 2.0 ** -11,
                        2.0 ** -17, 2.0 ** -25, 2.0 ** -133]
    vals = (rng.standard_normal((64, k)) * np.exp(
        rng.uniform(-30, 8, (64, k)))).astype(np.float32)
    vals[0, :len(small)] = small
    vals[1, :8] = [1e6, -1e6, 70000.0, 65504.0, 57344.0, 61440.0, 3.0e38,
                   -3.39e38]
    vals[2, :4] = [np.inf, -np.inf, np.nan, 1.0]
    x = torch.from_numpy(vals).cuda()
    eye = torch.eye(k, device="cuda")
    rows = []
    for impl, fmt, mode in (("hw", "e4m3", rne), ("hw", "e5m2", rne),
                            ("hw", "bfloat16", rne), ("hw", "e4m3", sr),
                            ("hw", "e5m2", sr), ("hw", "bfloat16", sr),
                            ("hw", "float16", rne), ("hw", "float16", sr),
                            ("bitexact", "e4m3", sr),
                            ("bitexact", "e5m2", rne)):
        for scale in (1.0, 3.7):
            sx = torch.tensor(scale, device="cuda")
            got = qmatmul.qdq_matmul(x, eye, fmt, mode, None, rne, sx,
                                     seed=123, impl=impl).cpu()
            want = qmatmul.cast_operand(
                x.cpu(), fmt, mode, sx.cpu(), impl,
                qmatmul.sr_key(123, 1, fmt, mode)) + 0.0
            finite = torch.isfinite(want).all(1)
            bad = bits_equal(got[finite], want[finite])
            nan_rows = bool(torch.isnan(got[~finite]).all())
            ok = bad == 0 and nan_rows
            rows.append({"impl": impl, "fmt": fmt, "mode": mode.name,
                         "scale": scale, "elements_differing": bad,
                         "rows_compared": int(finite.sum()),
                         "nonfinite_rows_all_nan": nan_rows, "ok": ok})
            print(f"k2 in-kernel cast {impl} {fmt} {mode.name} scale "
                  f"{scale}: {bad} of {int(finite.sum()) * k} elements "
                  f"differ from the plain cast (bit-exact required); "
                  f"{int((~finite).sum())} rows with a non-finite cast all "
                  f"NaN: {nan_rows} -> {'ok' if ok else 'FAIL'}")
    return rows


# -- phases k3, k5, k6 ---------------------------------------------------------

# (K, N) of the serving linears at full width (d_model 4096, 32 heads / 8 KV
# heads of 128, d_ff 11008): q/o, k/v, gate/up, down; then a ragged pair,
# which the wrappers send to the general kernel.
SERVE_KN = [(4096, 4096), (4096, 1024), (4096, 11008), (11008, 4096),
            (1001, 331)]
SERVE_MS = (1, 8, 64, 100, 2048)
# Row counts of the streaming loop's cases: each wgmma n (8, 16, 32, 64)
# full and one row past the smaller; then its prefill route's (M > 64):
# one row past decode, ragged and whole 128-token tiles, a split k/v, the
# 512-token prefill and the 8 x 256-token paged one.
STREAM_MS = (1, 8, 9, 16, 17, 63, 64)
PREFILL_MS = (65, 100, 128, 256, 512, 700, 2048)
GEMM_MS = tuple(sorted(set(SERVE_MS) | set(STREAM_MS) | set(PREFILL_MS)))


def gemm_tolerance(xb, w_abs, col_scale, want, out_dtype):
    """|kernel - plain| allowed for an f32-accumulated product of exact
    bf16 x bf16 terms: both sums carry at most K * 2^-24 of sum|x_i w_i|
    (summation order), times the column scale; a bf16 result may land one
    bf16 step (2^-7 relative) away when the two f32 values straddle a
    rounding boundary."""
    import torch
    from fp8tpu_torch._device import full_fp32
    k = xb.shape[1]
    with full_fp32():
        mag = torch.matmul(xb.float().abs(), w_abs)
    tol = 2.0 * k * 2.0 ** -24 * mag * col_scale + 1e-30
    if out_dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * want.float().abs()
    return tol


def stream_reference(xb, wq, col_scale, kper, out_dtype):
    """(exact, allowed |out - exact|) for the streaming loop's output
    (x @ wq) * col_scale: the f64 product, the f32 sum held to
    k2_reference's random-walk bound over the loop's promoted chunks
    (``qmatmul.promotion_edges``: 512 K rows a chunk from each split's
    start), then the scale's f32 product and, for bf16, the last rounding
    (2^-8 of the value).  Unlike the worst case K 2^-24 sum|x w|, it fails
    a dropped k16 step or chunk (trap 26)."""
    import torch
    from fp8tpu_torch.kernels.qmatmul import promotion_edges
    k = xb.shape[1]
    exact, tol = k2_reference(xb.float(), wq.float(),
                              promotion_edges(k, kper))
    s = torch.as_tensor(col_scale, dtype=torch.float64,
                        device=exact.device)
    exact = exact * s
    rel = 2.0 ** -24 + (2.0 ** -8 if out_dtype == torch.bfloat16 else 0.0)
    return exact, tol * s.abs() + rel * exact.abs() + 1e-30


def loop_references(xb, wq, col_scale, kper):
    """stream_reference for both result types from one f64 product:
    {torch.float32: (exact, allowed), torch.bfloat16: (...)}."""
    import torch
    exact, tol = stream_reference(xb, wq, col_scale, kper, torch.float32)
    return {torch.float32: (exact, tol),
            torch.bfloat16: (exact, tol + 2.0 ** -8 * exact.abs())}


def all_codes_case(rows, dtype, m, gen, fn, plain, label):
    """Every payload code through the kernel: column c of a (256, 256)
    payload holds code c in every row, x (M, 256) has one 1 a row, so each
    output is one code's value times its column's scale, exact, and NaN
    where the column holds a NaN or an inf (0 x inf).  Held to the plain
    version value for value (NaN where it is NaN; -0 reads +0)."""
    import torch
    codes = torch.arange(256, device="cuda", dtype=torch.uint8)
    w = codes.reshape(1, 256).expand(256, 256).contiguous().view(dtype)
    s = torch.rand(256, device="cuda", generator=gen) + 0.5
    x = torch.zeros(m, 256, device="cuda", dtype=torch.bfloat16)
    x[torch.arange(m), torch.arange(m)] = 1.0
    got, want = fn(x, w, s), plain(x, w, s)
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    bad = int((~same).sum())
    rows.append({"case": label, "max_abs_err": 0.0 if not bad else math.inf,
                 "max_err_over_bound": 0.0 if not bad else math.inf,
                 "differing": bad, "ok": bad == 0})
    if bad:
        print(f"  FAIL {label}: {bad} of {got.numel()} outputs differ")
    return bad == 0


def _gemm_case(rows, label, got, want, tol, again=None, reference=None):
    """One weight-GEMM case: the kernel within ``tol`` of the plain
    version; for the streaming loop (decode form or prefill route) also a
    second launch bit-equal to the first and the kernel within
    ``reference`` (exact, allowed) of the f64 product."""
    import torch
    err = (got.float() - want.float()).abs()
    ok = bool(torch.isfinite(got.float()).all()) and bool((err <= tol).all())
    row = {"case": label, "max_abs_err": float(err.max()),
           "max_err_over_bound": float((err / tol).max()), "ok": ok}
    if again is not None:
        row["repeat_bits"] = bits_equal(again, got)
        ok = ok and row["repeat_bits"] == 0
    if reference is not None:
        exact, allowed = reference
        ratio = k2_ratio(got, exact, allowed)
        row["err_over_f64_bound"] = ratio
        ok = ok and ratio <= 1.0
    row["ok"] = ok
    rows.append(row)
    if not ok:
        print(f"  FAIL {label}: max|err| {row['max_abs_err']:.3e}, err/bound "
              f"{row['max_err_over_bound']:.3e}, f64 "
              f"{row.get('err_over_f64_bound', 0.0):.3e}, repeat bits "
              f"{row.get('repeat_bits', 0)}")
    return ok


def _gemm_summary(name, rows, routes=None):
    worst = max(r["max_err_over_bound"] for r in rows)
    f64 = [r["err_over_f64_bound"] for r in rows if "err_over_f64_bound" in r]
    by_route = f" (launches by route {routes})" if routes else ""
    print(f"{name}: {len(rows)} cases, {len(f64)} on the streaming loop"
          f"{by_route}; worst err/bound {worst:.3e}, worst err/f64 bound "
          f"{max(f64):.3e}; {sum(not r['ok'] for r in rows)} failed")


def phase_k3(record):
    import torch
    from fp8tpu_torch.kernels import qmatmul

    gen = torch.Generator(device="cuda").manual_seed(3)
    sms = qmatmul.sm_count(0)
    rows = []
    qmatmul.reset_launches()
    for k, n in SERVE_KN:
        ms = GEMM_MS if k % 8 == 0 else SERVE_MS
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        w[:, 0] = 0.0                                   # an all-zero column
        xs = {m: torch.randn(m, k, device="cuda", generator=gen
                             ).to(torch.bfloat16) for m in ms}
        for fmt in ("e4m3", "e5m2", "int8"):
            w8, s = qmatmul.quantize_weights(w, fmt)
            s = s.reshape(-1)
            w_abs = w8.float().abs()
            for m, x in xs.items():
                plan = qmatmul.weight_gemm_plan(m, n, k, sms, "w8", x, w8)
                refs = None if plan.route == "general" else loop_references(
                    x, w8.float(), s.reshape(1, -1), plan.kper)
                for out_dtype in (torch.bfloat16, torch.float32):
                    before = qmatmul.dequant_launches
                    on_route = qmatmul.dequant_routes[plan.route]
                    got = qmatmul.dequant_matmul(x, w8, s, out_dtype)
                    if qmatmul.dequant_launches != before + 1 or \
                            qmatmul.dequant_routes[plan.route] != on_route + 1:
                        raise PhaseError("dequant_matmul did not count its "
                                         f"launch on the {plan.route} route")
                    want = qmatmul.dequant_matmul_plain(x, w8, s, out_dtype)
                    tol = gemm_tolerance(x, w_abs, s.reshape(1, -1), want,
                                         out_dtype)
                    again = ref = None
                    if refs is not None:
                        again = qmatmul.dequant_matmul(x, w8, s, out_dtype)
                        ref = refs[out_dtype]
                    _gemm_case(rows, f"k3 {fmt} M={m} K={k} N={n} "
                               f"{str(out_dtype)[6:]} {plan.route}",
                               got, want, tol, again, ref)
                del refs
    for fmt, dtype in (("e4m3", torch.float8_e4m3fn),
                       ("e5m2", torch.float8_e5m2), ("int8", torch.int8)):
        for m in (8, 128):                       # decode form, prefill route
            all_codes_case(
                rows, dtype, m, gen,
                lambda x, w, s: qmatmul.dequant_matmul(x, w, s, torch.float32),
                lambda x, w, s: qmatmul.dequant_matmul_plain(
                    x, w, s, torch.float32),
                f"k3 {fmt} all 256 codes M={m}")
    torch.cuda.synchronize()
    record["k3"] = rows
    _gemm_summary(f"k3 (e4m3/e5m2/int8 x bf16/f32 out x M in {GEMM_MS} x "
                  f"(K, N) in {SERVE_KN}, the ragged pair on the general "
                  "kernel; every code of each payload)", rows,
                  dict(qmatmul.dequant_routes))
    if not all(r["ok"] for r in rows):
        raise PhaseError("K3 disagrees with its plain version or the f64 "
                         "product")


def phase_k5(record):
    import torch
    from fp8tpu_torch.kernels import int4_matmul as k5
    from fp8tpu_torch.kernels import qmatmul

    gen = torch.Generator(device="cuda").manual_seed(5)
    sms = qmatmul.sm_count(0)
    rows = []
    k5.reset_launches()
    for k, n in SERVE_KN[:4] + [(1024, 331)]:
        ms = GEMM_MS if n % 16 == 0 else SERVE_MS
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        xs = {m: torch.randn(m, k, device="cuda", generator=gen
                             ).to(torch.bfloat16) for m in ms}
        for group in (None, 128):
            if group:
                wp, s = k5.quantize_weights_int4_grouped(w, group)
                sb = s.to(torch.bfloat16).repeat_interleave(group, dim=0)
                col = torch.ones(1, n, device="cuda")
            else:
                wp, s = k5.quantize_weights_int4_grouped(w, k)
                s = s.reshape(-1)
                sb = torch.ones(k, n, device="cuda", dtype=torch.bfloat16)
                col = s.reshape(1, -1)
            lo, hi = k5.unpack_int4(wp)
            wq = torch.stack([lo, hi], 1).reshape(k, n).to(torch.bfloat16)
            wq = wq * sb                      # the kernel's bf16 weights
            w_abs = wq.float().abs()
            for m, x in xs.items():
                plan = qmatmul.weight_gemm_plan(m, n, k, sms, "int4", x, wp, s,
                                                group=group)
                refs = None if plan.route == "general" else loop_references(
                    x, wq, col, plan.kper)
                for out_dtype in (torch.bfloat16, torch.float32):
                    before = k5.launches
                    on_route = k5.routes[plan.route]
                    got = k5.int4_matmul(x, wp, s, group, out_dtype)
                    if k5.launches != before + 1 or \
                            k5.routes[plan.route] != on_route + 1:
                        raise PhaseError("int4_matmul did not count its "
                                         f"launch on the {plan.route} route")
                    want = k5.int4_matmul_plain(x, wp, s, group, out_dtype)
                    tol = gemm_tolerance(x, w_abs, col, want, out_dtype)
                    again = ref = None
                    if refs is not None:
                        again = k5.int4_matmul(x, wp, s, group, out_dtype)
                        ref = refs[out_dtype]
                    _gemm_case(rows, f"k5 group={group} M={m} K={k} N={n} "
                               f"{str(out_dtype)[6:]} {plan.route}",
                               got, want, tol, again, ref)
                del refs
    torch.cuda.synchronize()
    record["k5"] = rows
    _gemm_summary(f"k5 (per-channel / group 128 x bf16/f32 out x M in "
                  f"{GEMM_MS}, N = 331 on the general kernel)", rows,
                  dict(k5.routes))
    if not all(r["ok"] for r in rows):
        raise PhaseError("K5 disagrees with its plain version or the f64 "
                         "product")


def phase_k6(record):
    import torch
    from fp8tpu_torch.kernels import inplace

    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = bad = 0

    def raw(shape, dtype):
        size = torch.empty((), dtype=dtype).element_size()
        n = 1
        for d in shape:
            n *= d
        return torch.randint(0, 256, (n * size,), device="cuda",
                             dtype=torch.uint8, generator=gen
                             ).view(dtype).reshape(shape)

    def bytes_of(t):
        return t.contiguous().view(torch.uint8)

    # 1-, 2- and 4-byte types; rows that are 16-byte aligned (the ring's
    # payload and scale slabs at full width) and rows that are not.
    shapes = [(512, 2, 16, 64, 128), (512, 2, 16, 64), (9, 7), (5, 3, 5)]
    for dtype in (torch.int8, torch.float8_e4m3fn, torch.bfloat16,
                  torch.float32):
        for shape in shapes:
            if dtype == torch.float32 and len(shape) == 5:
                shape = (64,) + shape[1:]
            n = shape[0]
            buf = raw(shape, dtype)
            ref = buf.clone()
            ptr = buf.data_ptr()
            for idx in (0, n - 1, n + 3, -1):
                slab = raw(shape[1:], dtype)
                before = inplace.launches
                out = inplace.dyn_store(
                    buf, slab, torch.tensor(idx, device="cuda",
                                            dtype=torch.int32))
                inplace.dyn_store_plain(ref, slab, idx)
                cases += 1
                if (inplace.launches != before + 1 or out is not buf
                        or buf.data_ptr() != ptr
                        or not torch.equal(bytes_of(buf), bytes_of(ref))):
                    bad += 1
                    print(f"  k6 FAIL {dtype} {shape} idx={idx}")
    # An unaligned slab (a view one element into its storage).
    buf = raw((8, 33), torch.int8)
    ref = buf.clone()
    slab = raw((34,), torch.int8)[1:]
    inplace.dyn_store(buf, slab, torch.tensor(3, device="cuda",
                                              dtype=torch.int32))
    ref[3] = slab
    cases += 1
    bad += int(not torch.equal(buf, ref))

    # The index is read on the device: capture one launch in a CUDA graph,
    # then change the index and the slab and replay it.
    buf = raw((512, 2, 16, 64, 128), torch.int8)
    ref = buf.clone()
    slab = raw(buf.shape[1:], torch.int8)
    idx = torch.tensor(2, device="cuda", dtype=torch.int32)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        inplace.dyn_store(buf, slab, idx)               # warm-up: row 2
    torch.cuda.current_stream().wait_stream(side)
    ref[2] = slab
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        inplace.dyn_store(buf, slab, idx)
    idx.fill_(515)                                      # 515 mod 512 = 3
    slab.copy_(raw(buf.shape[1:], torch.int8))
    graph.replay()
    torch.cuda.synchronize()
    ref[3] = slab
    cases += 1
    graph_ok = torch.equal(buf, ref)
    bad += int(not graph_ok)
    del buf, ref, slab
    ring = k6_ring_cases(raw, bytes_of)
    record["k6"] = {"cases": cases, "failed": bad, "graph_replay": graph_ok,
                    "ring_store": ring}
    print(f"k6: {cases} cases (int8, e4m3, bf16, f32; aligned and unaligned "
          f"rows; idx 0, n-1, n+3, -1; one CUDA-graph replay with a changed "
          f"device index: {'ok' if graph_ok else 'FAIL'}), {bad} failed "
          f"(bit-exact required)")
    print(f"k6 ring_store: {ring['cases']} cases (int8 and e4m3 rings of "
          f"{SERVE_SEQ} rows at 8 and 64 slots, and a slab of "
          f"{K6_WAVES_SLAB >> 20} MB, {ring['waves_blocks']} blocks; head 0, "
          f"n-1, n+3, -1; {K6_GRAPH_STEPS} steps captured in one CUDA graph "
          f"and replayed), {ring['failed']} failed (bytes, head and ticket "
          f"equal to ring_store_plain required)")
    if bad or ring["failed"]:
        raise PhaseError("K6 disagrees with its plain version")


K6_GRAPH_STEPS = 200           # ring_store calls in one captured graph
K6_WAVES_SLAB = 64 << 20       # a payload row that takes several waves


def k6_ring_cases(raw, bytes_of):
    """ring_store against ring_store_plain: bytes of both slabs, the head
    and the ticket, at the served decoder's ring (16 layers, 8 KV heads of
    128, 512 rows) at 8 and 64 slots with int8 and e4m3 payloads, heads 0,
    n - 1, n + 3 and -1; then K6_GRAPH_STEPS consecutive calls, each with
    a new slab, captured in one CUDA graph and replayed against the same
    steps in plain; and a payload row so long that its blocks run in
    several waves, where a block that read a moved head would write the
    wrong row."""
    import torch
    from fp8tpu_torch.kernels import inplace

    cfg = serve_config()
    cases = bad = 0

    def same(kv8, sc, head, ticket, kv8_p, sc_p, head_p):
        return (torch.equal(bytes_of(kv8), bytes_of(kv8_p))
                and torch.equal(bytes_of(sc), bytes_of(sc_p))
                and int(head) == int(head_p) and int(ticket) == 0)

    def i32(v):
        return torch.tensor(v, device="cuda", dtype=torch.int32)

    layouts = [((SERVE_SEQ, 2, cfg.n_layers, slots * cfg.n_kv_heads,
                 cfg.head_dim), (SERVE_SEQ, 2, cfg.n_layers,
                                 slots * cfg.n_kv_heads), dtype)
               for slots in (SERVE_SLOTS, BENCH_BATCH)
               for dtype in (torch.int8, torch.float8_e4m3fn)]
    layouts.append(((4, K6_WAVES_SLAB), (4, 3), torch.int8))
    for shape8, shapes, dtype in layouts:
        n = shape8[0]
        kv8, sc = raw(shape8, dtype), raw(shapes, torch.float32)
        kv8_p, sc_p = kv8.clone(), sc.clone()
        ticket = torch.zeros(1, device="cuda", dtype=torch.int32)
        label = f"{tuple(shape8)} {str(dtype)[6:]}"
        for h0 in (0, n - 1, n + 3, -1):
            slab8, slabs = raw(shape8[1:], dtype), raw(shapes[1:],
                                                       torch.float32)
            head, head_p = i32(h0), i32(h0)
            before = inplace.routes["ring_store"]
            inplace.ring_store(kv8, slab8, sc, slabs, head, n, ticket)
            inplace.ring_store_plain(kv8_p, slab8, sc_p, slabs, head_p, n)
            cases += 1
            if (inplace.routes["ring_store"] != before + 1
                    or not same(kv8, sc, head, ticket, kv8_p, sc_p, head_p)):
                bad += 1
                print(f"  k6 ring_store FAIL {label} head={h0}: head "
                      f"{int(head)} (plain {int(head_p)}), ticket "
                      f"{int(ticket)}")
        if n < K6_GRAPH_STEPS:
            continue
        # every replayed step writes its own slab: a lost or doubled
        # advance leaves a row that differs from the plain sequence
        slab8, slabs = raw(shape8[1:], dtype), raw(shapes[1:], torch.float32)
        start = n - K6_GRAPH_STEPS // 2                 # wraps around
        head = i32(start)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):                   # warm-up
            inplace.ring_store(kv8, slab8, sc, slabs, head, n, ticket)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(K6_GRAPH_STEPS):
                slab8.view(torch.uint8).add_(1)
                slabs.add_(1.0)
                inplace.ring_store(kv8, slab8, sc, slabs, head, n, ticket)
        kv8.copy_(kv8_p)                  # both rings as they were
        sc.copy_(sc_p)
        head.fill_(start)
        slab8_0, slabs_0 = slab8.clone(), slabs.clone()
        graph.replay()
        slab8.copy_(slab8_0)
        slabs.copy_(slabs_0)
        head_p = i32(start)
        for _ in range(K6_GRAPH_STEPS):
            slab8.view(torch.uint8).add_(1)
            slabs.add_(1.0)
            inplace.ring_store_plain(kv8_p, slab8, sc_p, slabs, head_p, n)
        torch.cuda.synchronize()
        cases += 1
        if not same(kv8, sc, head, ticket, kv8_p, sc_p, head_p):
            bad += 1
            rows = int((bytes_of(kv8).reshape(n, -1)
                        != bytes_of(kv8_p).reshape(n, -1)).any(1).sum())
            print(f"  k6 ring_store FAIL {label}: {K6_GRAPH_STEPS} replayed "
                  f"steps, head {int(head)} (plain {int(head_p)}), ticket "
                  f"{int(ticket)}, {rows} rows differ")
        del graph
    blocks = -(-K6_WAVES_SLAB // (16 * 4 * 256))   # 4 pieces a thread
    return {"cases": cases, "failed": bad, "waves_blocks": blocks}


# -- phase k4 ------------------------------------------------------------------

K4_KV, K4_G, K4_D, K4_PAGE, K4_LAYERS = 8, 4, 128, 64, 3
K4_GROUPS = (1, 2, 4, 8)
K4_SLOTS = (1, 8, 33, 64, 132)
K4_LENS = [0, 1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 511, 512]
KV_TORCH = {"int8": "int8", "e4m3": "float8_e4m3fn", "e5m2": "float8_e5m2",
            "bf16": "bfloat16"}


def k4_case(gen, batch, max_pages, fmt, exact, g=K4_G, lens=None):
    """A pool of ``batch * max_pages`` pages behind a shuffled page table,
    ``g`` queries a kv head, and ragged lengths: ``lens`` where given (the
    rest random), else 0, one token, a mid-page end, a page boundary, a
    full pool, the rest random.  Entries of the table past a
    slot's length are -1 (as the engine leaves them), and slot 6's whole row
    is -1 although its length is not 0 (a retired slot that keeps decoding).
    ``exact``: q on a 1/8 grid and payloads on a grid coarse enough that
    every score dot is exact in f32 in any order."""
    import torch
    dev = "cuda"
    P, R = batch * max_pages, K4_PAGE * K4_KV
    shape = (P, 2, K4_LAYERS, R, K4_D)
    dtype = getattr(torch, KV_TORCH[fmt])
    if fmt == "int8":
        pool = torch.randint(-127, 128, shape, device=dev, generator=gen,
                             dtype=torch.int8)
    elif exact:
        pool = (torch.randint(-15, 16, shape, device=dev, generator=gen,
                              dtype=torch.int8).float() * 0.25).to(dtype)
    else:
        pool = torch.cat([(torch.randn((min(64, P - i),) + shape[1:],
                                       device=dev, generator=gen) * 3
                           ).to(dtype) for i in range(0, P, 64)])
    sc = torch.empty((P, 2, K4_LAYERS, R), device=dev).uniform_(
        0.004, 0.02, generator=gen)
    if exact:
        q = (torch.randint(-16, 17, (batch, K4_KV * g, K4_D), device=dev,
                           generator=gen).float() / 8).to(torch.bfloat16)
    else:
        q = (torch.randn(batch, K4_KV * g, K4_D, device=dev, generator=gen)
             * 0.7).to(torch.bfloat16)
    full = max_pages * K4_PAGE
    given = lens
    lens = torch.randint(1, full + 1, (batch,), device=dev, generator=gen,
                         dtype=torch.int32)
    if given is None:
        given = [0, 1, K4_PAGE - 1, K4_PAGE, K4_PAGE + 3, full, K4_PAGE + 5]
    given = given[:batch]
    lens[:len(given)] = torch.tensor(given, dtype=torch.int32)
    table = torch.randperm(P, device=dev, generator=gen).to(torch.int32
                                                            ).reshape(batch,
                                                                      max_pages)
    mapped = torch.arange(max_pages, device=dev)[None] * K4_PAGE \
        < lens[:, None]
    table = torch.where(mapped, table, -1).to(torch.int32)
    if batch > 6:
        table[6] = -1
    return q, pool, sc, table, lens


def k4_reference(q, pool, sc, table, lens, layer, kv=K4_KV, page=K4_PAGE):
    """K4's function computed a second way (all pages gathered, one softmax,
    no recurrence) and the bounds of |kernel - plain| that go with it.

    Scores are f32 sums of D exact products, so two orders of summation
    differ by at most s_tol = 2 * D * 2^-24 * max_t(sum_d |q_d k_td| * ks_t),
    which is also the bound for m.  A weight p = exp(s - m) then carries a
    relative error of at most 2 * s_tol (plus a few ulps of exp), and p * vs
    rounded to bf16 may land one bf16 step (2^-7 relative) away.  So
      |l - l'|     <= l * (2 * s_tol + (T + 8) * 2^-23)
      |acc - acc'| <= A * (2 * s_tol + 2^-7 + (T + 8) * 2^-23),
    A = sum_t |pv_t| * |v_td|, T the tokens of the longest slot.
    Returns (acc, m, l, m_tol, l_tol, acc_tol)."""
    import torch
    from fp8tpu_torch._device import full_fp32
    B, KVG, D = q.shape
    KV, G = kv, KVG // kv
    MP = table.shape[1]
    T = MP * page
    safe = table.clamp(min=0).long()
    raw = pool.view(torch.uint8 if pool.element_size() == 1 else torch.int16)
    qh = q.float().reshape(B, KV, G, D)
    mask = (torch.arange(T, device=q.device)[None] < lens[:, None]
            )[:, None, None, :]
    with full_fp32():
        k = raw[safe, 0, layer].view(pool.dtype).float().reshape(B, T, KV, D)
        ks = sc[safe, 0, layer].reshape(B, T, KV).permute(0, 2, 1)[:, :, None]
        s = torch.einsum("bkgd,btkd->bkgt", qh, k) * ks
        s_abs = torch.einsum("bkgd,btkd->bkgt", qh.abs(), k.abs()) * ks
        del k
        s = torch.where(mask, s, -1e30)
        m = s.amax(-1)
        s_tol = 2.0 * D * 2.0 ** -24 * torch.where(mask, s_abs, 0.0).amax(-1)
        p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
        l = p.sum(-1)
        v = raw[safe, 1, layer].view(pool.dtype).float().reshape(B, T, KV, D)
        vs = sc[safe, 1, layer].reshape(B, T, KV).permute(0, 2, 1)[:, :, None]
        pv = (p * vs).to(torch.bfloat16).float()
        acc = torch.einsum("bkgt,btkd->bkgd", pv, v)
        a_abs = torch.einsum("bkgt,btkd->bkgd", pv, v.abs())
    rel = 2.0 * s_tol + (T + 8) * 2.0 ** -23
    return (acc.reshape(B, KVG, D), m.reshape(B, KVG), l.reshape(B, KVG),
            s_tol.reshape(B, KVG), (l * rel).reshape(B, KVG) + 1e-30,
            (a_abs * (rel + 2.0 ** -7)[..., None]).reshape(B, KVG, D) + 1e-30)


def phase_k4(record):
    import torch
    from fp8tpu_torch.kernels import paged_attention as k4

    gen = torch.Generator(device="cuda").manual_seed(44)
    kw = dict(page_size=K4_PAGE, kv_heads=K4_KV)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []

    def compare(label, args, layer, exact):
        before = k4.launches
        acc, m, l = k4.paged_decode_attention(*args, layer, **kw)
        if k4.launches != before + 1:
            raise PhaseError("paged_decode_attention did not count its launch")
        acc_p, m_p, l_p = k4.paged_decode_attention_plain(*args, layer, **kw)
        acc_r, m_r, l_r, m_tol, l_tol, acc_tol = k4_reference(*args, layer)
        torch.cuda.synchronize()
        # the plain version against the second reference: m bit-equal on
        # exact data, everything within the same bounds
        checks = {
            "m": bool(((m - m_p).abs() <= (0.0 if exact else 1.0) * m_tol
                       ).all()),
            "m_bits": bits_equal(m, m_p) == 0 if exact else True,
            "l": bool(((l - l_p).abs() <= l_tol).all()),
            "acc": bool(((acc - acc_p).abs() <= acc_tol).all()),
            "plain_vs_reference": bool(
                ((m_p - m_r).abs() <= m_tol).all()
                and ((l_p - l_r).abs() <= l_tol).all()
                and ((acc_p - acc_r).abs() <= acc_tol).all()),
            "finite": bool(torch.isfinite(acc).all()
                           and torch.isfinite(l).all()),
        }
        lens = args[4]
        empty = lens == 0
        if bool(empty.any()):
            checks["empty_slot"] = bool(
                (m[empty] == -1e30).all() and (l[empty] == 0).all()
                and (acc[empty] == 0).all())
        ok = all(checks.values())
        rows.append({"case": label, "ok": ok, "checks": checks,
                     "max_abs_err": float((acc - acc_p).abs().max()),
                     "max_err_over_bound": float(
                         ((acc - acc_p).abs() / acc_tol).max()),
                     "l_err_over_bound": float(
                         ((l - l_p).abs() / l_tol).max())})
        if not ok:
            print(f"  k4 FAIL {label}: {checks}")
        return acc, m, l

    shapes = [(8, 8), (8, 16), (64, 8), (64, 16)]
    for batch, max_pages in shapes:
        for fmt in ("int8", "e4m3"):
            for exact in (True, False):
                args = k4_case(gen, batch, max_pages, fmt, exact)
                for layer in range(K4_LAYERS):
                    compare(f"B={batch} MP={max_pages} {fmt} "
                            f"{'exact-dot' if exact else 'gaussian'} data "
                            f"layer {layer}", args, layer, exact)
                del args
    for fmt in ("e5m2", "bf16"):
        for exact in (True, False):
            args = k4_case(gen, 8, 8, fmt, exact)
            compare(f"B=8 MP=8 {fmt} {'exact-dot' if exact else 'gaussian'} "
                    f"data layer 1", args, 1, exact)
    # every query group and payload; slot counts across the split plan's
    # edges (1 slot: 8 splits; 8: 4; 33, 64, 132: one, past one wave at 132);
    # lengths at 0, 1 and a chunk, a round of four chunks and a page, +- 1
    for g in K4_GROUPS:
        for fmt in KV_TORCH:
            args = k4_case(gen, 8, 8, fmt, True, g=g)
            compare(f"G={g} B=8 MP=8 {fmt} exact-dot data layer 2", args, 2,
                    True)
    for batch in K4_SLOTS:
        args = k4_case(gen, batch, 8, "int8", True,
                       lens=[444, 0, 1, 63, 64, 67, 512, 69])
        compare(f"B={batch} MP=8 int8 exact-dot data layer 0 "
                f"({k4.n_splits(batch, K4_KV, 8 * K4_PAGE, sms)} splits)",
                args, 0, True)
    args = k4_case(gen, len(K4_LENS), 8, "int8", True, lens=K4_LENS)
    compare(f"lengths {K4_LENS} int8 exact-dot data layer 1", args, 1, True)
    args = k4_case(gen, len(K4_LENS), 8, "e4m3", False, lens=K4_LENS)
    compare(f"lengths {K4_LENS} e4m3 gaussian data layer 1", args, 1, False)

    # a second launch gives the same bits (the split partials are merged in a
    # fixed order), at the split shape (8 slots) and the unsplit one (64)
    repeat_ok = True
    for batch in (1, 8, 33, 64):
        args = k4_case(gen, batch, 8, "int8", False)
        first = k4.paged_decode_attention(*args, 2, **kw)
        for _ in range(3):
            again = k4.paged_decode_attention(*args, 2, **kw)
            repeat_ok &= all(bits_equal(a, b) == 0
                             for a, b in zip(first, again))

    # The table and the lengths are read on the device: capture one launch in
    # a CUDA graph, then change both in place and replay it.
    q, pool, sc, table, lens = args = k4_case(gen, 8, 8, "int8", False)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k4.paged_decode_attention(*args, 0, **kw)               # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = k4.paged_decode_attention(*args, 0, **kw)
    _, _, _, table2, lens2 = k4_case(gen, 8, 8, "int8", False)
    table.copy_(table2)
    lens.copy_(lens2)
    graph.replay()
    torch.cuda.synchronize()
    want = k4.paged_decode_attention_plain(q, pool, sc, table, lens, 0, **kw)
    _, _, _, m_tol, l_tol, acc_tol = k4_reference(q, pool, sc, table, lens, 0)
    graph_ok = bool(((out[0] - want[0]).abs() <= acc_tol).all()
                    and ((out[1] - want[1]).abs() <= m_tol).all()
                    and ((out[2] - want[2]).abs() <= l_tol).all())

    record["k4"] = {"cases": rows, "repeatable": repeat_ok,
                    "graph_replay": graph_ok}
    worst = max(r["max_err_over_bound"] for r in rows)
    worst_l = max(r["l_err_over_bound"] for r in rows)
    print(f"k4: {len(rows)} cases (int8 / e4m3 x exact-dot / gaussian data x "
          f"(B, MP) in {shapes} x 3 layers; e5m2 and bf16 at B=8 MP=8; G in "
          f"{K4_GROUPS} x every payload; B in {K4_SLOTS}; lengths "
          f"{K4_LENS}); m bit-equal on exact-dot data; worst acc err/bound "
          f"{worst:.3e}, l err/bound {worst_l:.3e}; repeated launches "
          f"bit-equal: {'ok' if repeat_ok else 'FAIL'}; CUDA-graph replay "
          f"with a changed table and lengths: "
          f"{'ok' if graph_ok else 'FAIL'}")
    if not (all(r["ok"] for r in rows) and repeat_ok and graph_ok):
        raise PhaseError("K4 disagrees with its plain version")

# -- phases t1, t2: the convert studies ---------------------------------------

def _study_row(name, replaces, source, mode, launches, err, ms, warm_ms,
               plain_ms, bound, bound_by, library_ms):
    return {"name": f"{name}[{mode}]", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "warm_ms": warm_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms}


def phase_t1(record):
    """T1 at the tool's shapes through its entry point, then each mode's
    kernel against the plain version and the f64 reference."""
    import torch
    from fp8tpu_torch.kernels import kexp_convert as t1
    from fp8tpu_torch.tools import kexp_convert as tool

    t1.reset_launches()
    with _Counting(t1, "stream_plain", forbid=True):
        res = tool.run("cuda")
    counts = dict(t1.mode_launches)
    torch.cuda.synchronize()
    problems = []
    for m in ("conv-bits", "conv-astype"):
        if res[f"{m} mismatches"]:
            problems.append(f"{m}: {res[m + ' mismatches']} of 256 e4m3 "
                            "bytes convert wrongly")
    if any(counts[m] < 1 for m in t1.MODES):
        problems.append(f"a mode never launched its kernel: {counts}")

    q, k8, kb = tool.make_inputs(tool.B * tool.KV, "cuda")
    reps, rows, kernels = 8, [], []
    for mode in t1.MODES:
        arr = kb if mode in t1.BF16_MODES else k8
        r = res["modes"][mode]
        warm, fold_w = r["out"], r["fold"]
        again = t1.stream(q, arr, mode, reps=reps)
        cold = t1.stream(q, arr, mode, reps=reps, cold=True)
        want, want_fold = t1.stream_plain(q, arr, mode, reps=reps)
        exact, tol, fold_exact, fold_tol = t1.error_bound(q, arr, mode, reps)
        row = {"mode": mode,
               "repeat_bits": bits_equal(again[0], warm)
               + bits_equal(again[1], fold_w),
               "cold_bits": bits_equal(cold[0], warm)
               + bits_equal(cold[1], fold_w),
               "max_abs_err": float((warm - want).abs().max()),
               "err_over_tol": k2_ratio(warm, exact, tol),
               "plain_err_over_tol": k2_ratio(want, exact, tol),
               "fold_err_over_tol": float(
                   ((fold_w.double() - fold_exact).abs() / fold_tol).max())}
        if mode in ("conv-astype", "conv-bits"):
            row["plain_bits"] = bits_equal(warm, want) + bits_equal(fold_w,
                                                                    want_fold)
            ok = row["plain_bits"] == 0
        else:
            ok = row["err_over_tol"] <= 1.0 and row["fold_err_over_tol"] <= 1.0
        ok = ok and row["repeat_bits"] == 0 and row["cold_bits"] == 0
        row["ok"] = ok
        rows.append(row)
        print(f"t1 {mode}: |kernel - plain| {row['max_abs_err']:.3e}, "
              f"err/tol kernel {row['err_over_tol']:.3e} plain "
              f"{row['plain_err_over_tol']:.3e}, fold err/tol "
              f"{row['fold_err_over_tol']:.3e}, bits differing: plain "
              f"{row.get('plain_bits', '-')}, repeat {row['repeat_bits']}, "
              f"warm vs cold {row['cold_bits']} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            problems.append(f"T1 {mode} disagrees (see its line)")

        plain_ms = cuda_ms(lambda: t1.stream_plain(q, arr, mode, reps=1),
                           iters=3, warmup=1)
        # the conv modes read no q
        nbytes = (r["k_bytes"] + 4 * t1.G * t1.D + 4 * arr.shape[0]
                  + (0 if mode.startswith("conv") else r["q_bytes"]))
        flops = 0 if mode.startswith("conv") else (
            2.0 * t1.G * t1.S * t1.D * arr.shape[0]
            * (2 if mode.startswith("full") else 1))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_TC_FLOPS * 1e3
        row.update(warm_ms=r["warm_ms"], cold_ms=r["cold_ms"],
                   plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops))
        print(f"time t1 {mode}: warm {r['warm_ms']:.5f} ms, cold "
              f"{r['cold_ms']:.5f} ms a rep, plain {plain_ms:.4f} ms, bound "
              f"{max(t_bytes, t_ops):.5f} ms (bytes), no PyTorch call computes "
              f"this; {counts[mode]} launches")
        kernels.append(_study_row(
            "kexp_convert", "tools/kexp_convert.py:91",
            "fp8tpu_torch/kernels/csrc/kexp_convert.cu", mode, counts[mode],
            row["max_abs_err"], r["cold_ms"], r["warm_ms"], plain_ms,
            max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", None))
    # the converts' SASS instructions a byte, and every byte pair through
    # the bits convert at each byte position T1 uses
    from fp8tpu_torch.tools import bench_t1k6
    lib, sass = bench_t1k6.build_probe(os.path.dirname(os.path.abspath(
        __file__)))
    per_byte = bench_t1k6.sass_per_byte(sass)
    pairs = bench_t1k6.pair_mismatches(lib)
    print(f"t1 converts: SASS instructions a byte {per_byte}; bits convert "
          f"over the 65536 byte pairs, mismatches by byte position {pairs}")
    if any(pairs.values()):
        problems.append(f"the bits convert differs from the tool on byte "
                        f"pairs: {pairs}")
    record["t1"] = {"rows": rows, "launches": counts,
                    "sass_per_byte": per_byte, "pair_mismatches": pairs}
    if problems:
        raise PhaseError("; ".join(problems))
    return kernels


def phase_t2(record):
    """T2 at the tool's shapes through its entry point, then each mode's
    kernel against the plain version."""
    import torch
    from fp8tpu_torch.kernels import fp8_linear_study as t2
    from fp8tpu_torch.tools import bench_fp8_linear as tool

    t2.reset_launches()
    with _Counting(t2, "linear_plain", forbid=True):
        res = tool.run("cuda")
    counts = dict(t2.mode_launches)
    torch.cuda.synchronize()
    problems = []
    for m in ("pl-astype", "pl-bits", "pl-magic"):
        if res[f"{m} mismatches"]:
            problems.append(f"{m}: {res[m + ' mismatches']} of 256 e4m3 "
                            "bytes convert wrongly")
    for m in ("pl-bits", "pl-magic"):
        if res["modes"][m]["vs_astype"]:
            problems.append(f"{m} is not bit-identical to pl-astype")
    if any(counts[m] < 1 for m in t2.MODES):
        problems.append(f"a mode never launched its kernel: {counts}")

    x, w8, wb = tool.make_inputs(tool.K, tool.N, "cuda")
    m_, k_, n_ = x.shape[0], tool.K, tool.N
    reps, rows, kernels = 64, [], []
    for mode in t2.MODES:
        w = wb if mode == "pl-bf16" else w8
        got = res["modes"][mode]["out"]
        again = t2.linear(x, w, mode, reps=reps)
        cold = t2.linear(x, w, mode, reps=reps, cold=True)
        want = t2.linear_plain(x, w, mode)
        w_abs = t2.weight_values(w, mode).float().abs()
        tol = gemm_tolerance(x, w_abs, 1.0, want, torch.bfloat16)
        case = []
        ok = _gemm_case(case, f"t2 {mode}", got, want, tol)
        row = dict(case[0], mode=mode, repeat_bits=bits_equal(again, got),
                   cold_bits=bits_equal(cold, got))
        ok = ok and row["repeat_bits"] == 0 and row["cold_bits"] == 0
        row["ok"] = ok
        rows.append(row)
        print(f"t2 {mode}: |kernel - plain| {row['max_abs_err']:.3e}, "
              f"err/bound {row['max_err_over_bound']:.3e}, bits differing: "
              f"repeat {row['repeat_bits']}, warm vs cold {row['cold_bits']} "
              f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            problems.append(f"T2 {mode} disagrees (see its line)")
        del again, cold

        plain_ms = cuda_ms(lambda: t2.linear_plain(x, w, mode), iters=3,
                           warmup=1)
        nbytes = w.numel() * w.element_size() + 2 * (m_ * k_ + m_ * n_)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2.0 * m_ * n_ * k_ / BF16_TC_FLOPS * 1e3
        library = res["xla-bf16_ms"] if mode == "pl-bf16" else None
        r = res["modes"][mode]
        row.update(warm_ms=r["warm_ms"], cold_ms=r["cold_ms"],
                   plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                   library_ms=library)
        print(f"time t2 {mode}: warm {r['warm_ms']:.5f} ms, cold "
              f"{r['cold_ms']:.5f} ms a pass, plain {plain_ms:.4f} ms, bound "
              f"{max(t_bytes, t_ops):.5f} ms (bytes), library "
              f"{'x @ wb ' + format(library, '.5f') + ' ms' if library else 'none'}"
              f"; {counts[mode]} launches")
        kernels.append(_study_row(
            "fp8_linear_study", "tools/bench_pallas_linear.py:108",
            "fp8tpu_torch/kernels/csrc/fp8_linear_study.cu", mode,
            counts[mode], row["max_abs_err"], r["cold_ms"], r["warm_ms"],
            plain_ms, max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", library))
    # every mode at the serving linears' full widths and the streaming
    # loop's row counts: the plain version, a second launch, the f64 product
    from fp8tpu_torch.kernels import qmatmul
    gen = torch.Generator(device="cuda").manual_seed(7)
    sms = qmatmul.sm_count(0)
    cases = []
    for k, n in SERVE_KN[:4]:
        wf = torch.randn(k, n, device="cuda", generator=gen) * 0.02
        ws_ = {"pl-bf16": wf.to(torch.bfloat16),
               "e4m3": wf.to(torch.float8_e4m3fn)}
        for m in STREAM_MS:
            x = torch.randn(m, k, device="cuda", generator=gen
                            ).to(torch.bfloat16)
            for mode in t2.MODES:
                w = ws_["pl-bf16" if mode == "pl-bf16" else "e4m3"]
                got = t2.linear(x, w, mode, reps=1)
                again = t2.linear(x, w, mode, reps=1)
                want = t2.linear_plain(x, w, mode)
                wv = t2.weight_values(w, mode)
                tol = gemm_tolerance(x, wv.float().abs(), 1.0, want,
                                     torch.bfloat16)
                kper = qmatmul.stream_plan(
                    m, n, k, sms, "bf16" if mode == "pl-bf16" else "w8").kper
                _gemm_case(cases, f"t2 {mode} M={m} K={k} N={n}", got, want,
                           tol, again, stream_reference(
                               x, wv, 1.0, kper, torch.bfloat16))
    _gemm_summary(f"t2 (4 modes x M in {STREAM_MS} x (K, N) in "
                  f"{SERVE_KN[:4]})", cases)
    if not all(r["ok"] for r in cases):
        problems.append("T2 disagrees at the serving shapes (see the FAIL "
                        "lines)")
    record["t2"] = {"rows": rows, "cases": cases, "launches": counts,
                    "xla_fp8_ms": res["xla-fp8_ms"],
                    "xla_bf16_ms": res["xla-bf16_ms"]}
    torch.cuda.empty_cache()
    if problems:
        raise PhaseError("; ".join(problems))
    return kernels


# -- phase 4 ----------------------------------------------------------------

def phase_main(record, batch: int):
    import torch
    import fp8tpu_torch as ft
    from fp8tpu_torch.kernels import cast_kernel, qmatmul
    from fp8tpu_torch.models import RESNET_EXEMPT, resnet50
    from fp8tpu_torch.ops.scale_shift import fold_batchnorm
    from fp8tpu_torch.quant.interceptor import quantize_params

    gen = torch.Generator().manual_seed(0)
    cgen = torch.Generator(device="cuda").manual_seed(0)
    model = resnet50(device="cuda", generator=gen)
    inf_model = resnet50(device="cuda", norm_mode="scale_shift")
    batches = [torch.randn(batch, 3, 224, 224, device="cuda", generator=cgen)
               for _ in range(3)]
    calib, x = batches[:2], batches[2]
    with torch.no_grad():
        model.train()
        for b in calib:
            model(b)
        model.eval()
        ref = model(x)
    policy = ft.get_policy("e4m3").with_hw_patching()

    cast_kernel.reset_launches()
    qmatmul.reset_launches()
    t0 = time.perf_counter()
    qm = ft.quantize_model(model, (x,), dtype="e4m3", policy=policy,
                           fuse_bn=True, inference_model=inf_model,
                           calibration_batches=calib,
                           list_exempt_layers=RESNET_EXEMPT)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    with torch.no_grad():
        k1_0, k2_0 = cast_kernel.launches, qmatmul.launches
        pre_0 = qmatmul.k2_launches["prepass"]
        out = qm(x)                                # warm-up
        torch.cuda.synchronize()
        per_fwd = {"cast_kernel": cast_kernel.launches - k1_0,
                   "qdq_matmul": qmatmul.launches - k2_0,
                   "qdq_matmul_prepass": qmatmul.k2_launches["prepass"]
                   - pre_0}
        times = []
        for _ in range(3):
            t = time.perf_counter()
            out = qm(x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
    launches = {"cast_kernel": cast_kernel.launches,
                "qdq_matmul": qmatmul.launches,
                "qdq_matmul_prepass": qmatmul.k2_launches["prepass"]}
    ms = 1000.0 * sum(times) / len(times)
    record["profile"] = profile_forward(qm, x, ms)
    print(f"main: ResNet-50 e4m3 hw-patched PTQ, batch {batch}, 224x224: "
          f"quantize_model {quantize_s:.2f} s, {ms:.2f} ms/batch, "
          f"{batch / (ms / 1000.0):.1f} images/s "
          f"(batches: {', '.join(f'{1000 * t:.2f}' for t in times)} ms)")
    print(f"main: launches per forward {per_fwd}; in the whole run "
          f"{launches}")

    finite = bool(torch.isfinite(out).all())
    corr = float(torch.corrcoef(torch.stack(
        [out.flatten().double(), ref.flatten().double()]))[0, 1])
    agree = float((out.argmax(-1) == ref.argmax(-1)).float().mean())
    print(f"main: logits {tuple(out.shape)} finite={finite}, corr vs fp32 "
          f"{corr:.5f}, top-1 agreement {agree:.3f}")

    # The quantized weights (K1 on the card) against the CPU path's (plain
    # casts, held against the JAX package by the tests): bit-equal.
    host = fold_batchnorm({k: v.detach().cpu()
                           for k, v in model.state_dict().items()})
    host_q = quantize_params(host, qm.policy, qm.module_table)
    w_diff = sum(bits_equal(host_q[k], qm.variables[k].cpu()) for k in host_q)
    print(f"main: quantized weights, card vs CPU path: {w_diff} elements "
          f"differ (bit-exact required)")

    record["main"] = {
        "batch": batch, "ms_per_batch": ms, "images_per_s": batch / (ms / 1e3),
        "batch_ms": [1000 * t for t in times], "quantize_model_s": quantize_s,
        "launches_per_forward": per_fwd, "launches": launches,
        "corr_vs_fp32": corr, "top1_agreement": agree, "finite": finite,
        "weight_mismatches": w_diff,
    }
    problems = []
    if tuple(out.shape) != (batch, 1000) or not finite:
        problems.append("logits not finite or of the wrong shape")
    if corr <= 0.95:
        problems.append(f"correlation {corr} <= 0.95")
    if per_fwd["qdq_matmul"] != 52:
        problems.append(f"{per_fwd['qdq_matmul']} K2 launches per forward, "
                        "expected 52")
    if per_fwd["qdq_matmul_prepass"] != 104:
        problems.append(f"{per_fwd['qdq_matmul_prepass']} K2 pre-pass "
                        "launches per forward, expected 104 (activation "
                        "and weight of each conv)")
    if per_fwd["cast_kernel"] != 32:
        problems.append(f"{per_fwd['cast_kernel']} K1 launches per forward, "
                        "expected 32")
    if not all(launches.values()):
        problems.append(f"a kernel was not launched: {launches}")
    if w_diff:
        problems.append("quantized weights differ between card and CPU")
    if problems:
        raise PhaseError("; ".join(problems))
    return launches


def profile_forward(qm, x, forward_ms: float):
    """Device time of one quantized forward by kernel, from torch.profiler;
    fails if the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as p:
        profile_lead_in()
        qm(x)
        torch.cuda.synchronize()
    by_name = {}
    for e in p.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                LEAD_KERNEL in e.name:
            continue
        us = getattr(e, "device_time", None) or e.cuda_time
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + us / 1000.0, n + 1)
    rows = sorted(((t, n, k) for k, (t, n) in by_name.items()), reverse=True)
    busy = sum(t for t, _, _ in rows)
    if not busy > 0:
        raise PhaseError("torch.profiler recorded no device time")
    print(f"profile: one forward, {busy:.2f} ms of kernels on the device "
          f"against {forward_ms:.2f} ms per batch (busy share "
          f"{busy / forward_ms:.3f}); top kernels:")
    for t, n, k in rows[:8]:
        print(f"  {t:8.3f} ms {n:4d}x  {k[:90]}")
    return {"device_ms": busy, "forward_ms": forward_ms,
            "kernels": [{"name": k, "ms": t, "count": n}
                        for t, n, k in rows]}



# -- phase train --------------------------------------------------------------

TRAIN_STEPS = 4                # timed steps, after one warm-up step
TRAIN_LR = 1e-3                # SGD, momentum 0.9 (examples/resnet_qat.py)
# One step's conv weight gradients with the kernels against the same step
# with K2's plain version, relative L2.  A random-init ResNet-50 in train
# mode is chaotic: a one-ulp change of an f32 sum early on (moving an
# activation across an e4m3 rounding boundary, or a BatchNorm statistic)
# grows layer by layer to an O(1) change of the late activations and of
# every gradient.  So the tolerance is what summation order alone does in
# the same run: the plain version with f32 sums against the plain version
# with f64 sums.  The strict check is per launch: each of the step's K2
# launches against the exact product of its own operands, within the f32
# summation-order tolerance (k2_reference).
TRAIN_GRAD_RATIO = 1.5


def k2_plain_f64(x, w, fmt_x, mode_x, fmt_w, mode_w, scale_x=1.0,
                 scale_w=1.0, seed=0, impl="bitexact"):
    """K2's plain version with the sums in f64: the plain casts, then an
    f64 contraction rounded once to f32."""
    xq, wq = k2_operands(x, w, fmt_x, mode_x, fmt_w, mode_w, scale_x,
                         scale_w, seed, impl)
    return (xq.double() @ wq.double()).float()


def k2_operands(x, w, fmt_x, mode_x, fmt_w, mode_w, scale_x, scale_w, seed,
                impl):
    """The two cast operands of a K2 launch, as its plain version makes
    them."""
    from fp8tpu_torch.kernels import qmatmul
    x, w = x.float(), w.float()
    sx, sw = qmatmul._scales(x, w, scale_x, scale_w)
    if fmt_x is not None:
        x = qmatmul.cast_operand(x, fmt_x, mode_x, sx[0], impl,
                                 qmatmul.sr_key(seed, 1, fmt_x, mode_x))
    if fmt_w is not None:
        w = qmatmul.cast_operand(w, fmt_w, mode_w, sw.reshape(1, -1), impl,
                                 qmatmul.sr_key(seed, 2, fmt_w, mode_w))
    return x, w


def conv_plain_f64(x, weight, strides, pads, fmt, mode, scale, seed=0,
                   impl="bitexact"):
    """The engine conv's plain version with the sums in f64."""
    col, w2d = k2_conv_operands(x, weight, strides, pads, fmt, mode, scale,
                                seed, impl)
    kh, kw = weight.shape[2:]
    oh = (x.shape[2] + sum(pads[0]) - kh) // strides[0] + 1
    ow = (x.shape[3] + sum(pads[1]) - kw) // strides[1] + 1
    out = (col.double() @ w2d.double()).float()
    return out.reshape(x.shape[0], oh, ow, -1).permute(0, 3, 1, 2)


def k2_launch_error(out, args, impl) -> float:
    """max |K2 - exact| / summation-order tolerance over one launch."""
    return k2_ratio(out, *k2_reference(*k2_operands(*args, impl)))


def xent(apply_fn, params, batch):
    import torch.nn.functional as F
    x, y = batch
    return F.cross_entropy(apply_fn(params, x), y)


def phase_train(record, batch: int):
    """FP8 mixed-precision training of ResNet-50 at full width: the hybrid
    recipe (e4m3 forward, e5m2 SR gradients, fp16 SR master copy) with hw
    patching, so every conv but the stem runs K2's "hw" route forward and
    two uncast K2 GEMMs backward."""
    import dataclasses
    import torch
    import fp8tpu_torch as ft
    from fp8tpu_torch.kernels import cast_kernel, qmatmul
    from fp8tpu_torch.models import RESNET_EXEMPT, resnet50
    from fp8tpu_torch.numerics import cast as cast_mod
    from fp8tpu_torch.numerics import prng
    from fp8tpu_torch.quant.policy import LayerKind
    from fp8tpu_torch.training import (LossScaleState, init_train_state,
                                       make_train_step, step_grads)

    model = resnet50(device="cuda", generator=torch.Generator().manual_seed(0))
    model.train()
    emu = ft.initialize(model, training_algo="hybrid", master_fmt="fp16",
                        exempt_layers=RESNET_EXEMPT)
    emu = dataclasses.replace(emu, policy=emu.policy.with_hw_patching())
    params = dict(model.named_parameters())
    opt = torch.optim.SGD(params.values(), lr=TRAIN_LR, momentum=0.9)
    step = make_train_step(emu, xent, loss_scale=2.0 ** 12)
    state = init_train_state(opt, 2.0 ** 12)
    cgen = torch.Generator(device="cuda").manual_seed(5)
    batches = [(torch.randn(batch, 3, 224, 224, device="cuda", generator=cgen),
                torch.randint(0, 1000, (batch,), device="cuda",
                              generator=cgen))
               for _ in range(1 + TRAIN_STEPS)]
    key = prng.key(1)
    convs = [n for n in params if n.endswith(".weight")
             and emu.module_table.get(n.rpartition(".")[0].replace(".", "/"))
             == LayerKind.CONV]

    # The main path: 1 warm-up and TRAIN_STEPS timed steps, counted.
    per_step, losses, scales, times = [], [], [], []
    cast_kernel.reset_launches()
    qmatmul.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _Counting(qmatmul, "plain", forbid=True), \
            _Counting(cast_mod, "qdq_plain", forbid=True):
        for i, b in enumerate(batches):
            k2_0, k1_0 = dict(qmatmul.k2_launches), cast_kernel.launches
            t = time.perf_counter()
            params, state, loss = step(params, state, b, prng.fold_in(key, i))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            per_step.append({**{v: qmatmul.k2_launches[v] - k2_0[v]
                                for v in k2_0},
                             "cast_kernel": cast_kernel.launches - k1_0})
            losses.append(float(loss))
            scales.append((state[1].scale, state[1].good_steps))
    launches = {"qdq_matmul_hw": qmatmul.k2_launches["hw"],
                "qdq_matmul_uncast": qmatmul.k2_launches["uncast"],
                "qdq_matmul_prepass": qmatmul.k2_launches["prepass"]}
    peak = torch.cuda.max_memory_allocated()
    ms = 1000.0 * sum(times[1:]) / TRAIN_STEPS
    print(f"train: ResNet-50 hybrid FP8 with hw patching, batch {batch}, "
          f"224x224: {ms:.2f} ms/step, {batch / (ms / 1000.0):.1f} images/s "
          f"(warm-up {1000 * times[0]:.1f} ms; steps "
          f"{', '.join(f'{1000 * t:.2f}' for t in times[1:])} ms); peak "
          f"device memory {peak / 2 ** 30:.2f} GiB")
    print(f"train: launches per step {per_step[-1]}; losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; loss scale "
          f"{scales}; no plain version called")

    problems = []
    # each conv: one implicit-GEMM forward ("hw") and the uncast dX and dW
    # GEMMs; pre-passes over the forward's activation and weight, dX's g
    # and weight and dW's g (dW reads the transposed im2col as it is)
    want = {"bitexact": 0, "hw": 52, "uncast": 104, "prepass": 260,
            "prepass_block": 0, "cast_kernel": 0}
    if any(p != want for p in per_step):
        problems.append(f"launches per step {per_step}, expected {want}")
    if not all(map(math.isfinite, losses)):
        problems.append(f"losses not finite: {losses}")
    prev = LossScaleState(2.0 ** 12)
    for got in scales:
        clean = (prev.scale, prev.good_steps + 1)
        if got != clean:
            problems.append(f"loss-scale step {prev} -> {got}: the steps "
                            "were to be clean")
        prev = LossScaleState(*got)

    # One step's gradients: with the kernels, every launch also held
    # against the plain version on its own operands; with K2's plain
    # version; with the plain casts and f64 sums.
    gkey = prng.fold_in(key, 100)
    launch, conv, checked = qmatmul._launch, qmatmul.conv, []

    def checking(*args, impl="bitexact", unsplit=False):
        out = launch(*args, impl=impl, unsplit=unsplit)
        checked.append(k2_launch_error(out, args, impl))
        return out

    def checking_conv(*args):
        out = conv(*args)
        checked.append(k2_ratio(conv_rows(out), *k2_reference(
            *k2_conv_operands(*args))))
        return out

    # Two witnesses that the kernel-vs-plain spread is the network's: the
    # plain pass repeated gives the same bits (no cast scale or SR stream
    # differs between passes), and with every cast off ("off") f32 and f64
    # sums stay close (the casts turn one-ulp differences into grid steps).
    off = dataclasses.replace(emu, policy=dataclasses.replace(
        emu.policy, default=emu.policy.default.without_roles(
            "wt", "iact", "oact", "wtgrad", "igrad", "ograd")))
    grads = {}
    for name, fn, cfn, e in (
            ("kernel", checking, checking_conv, emu),
            ("plain", qmatmul.plain, qmatmul.conv_plain, emu),
            ("plain_again", qmatmul.plain, qmatmul.conv_plain, emu),
            ("plain_f64", k2_plain_f64, conv_plain_f64, emu),
            ("off", qmatmul.plain, qmatmul.conv_plain, off),
            ("off_f64", k2_plain_f64, conv_plain_f64, off)):
        qmatmul._launch, qmatmul.conv = fn, cfn
        try:
            grads[name] = step_grads(e, xent, params, batches[0], gkey,
                                     2.0 ** 12)[1]
        finally:
            qmatmul._launch, qmatmul.conv = launch, conv

    def rel(a, b):
        return {n: float((grads[a][n] - grads[b][n]).norm()
                         / grads[b][n].norm().clamp_min(1e-30))
                for n in convs}

    rel_kp, rel_floor = rel("kernel", "plain"), rel("plain", "plain_f64")
    rel_off = rel("off", "off_f64")
    repeat_bad = sum(bits_equal(grads["plain"][n], grads["plain_again"][n])
                     for n in params)
    over = {n: rel_kp[n] / max(rel_floor[n], 1e-12) for n in convs}
    worst = max(over, key=over.get)
    zero = [n for n in convs if not float(grads["kernel"][n].abs().max()) > 0]
    launch_worst = max(checked)
    print(f"train: one step's {len(checked)} K2 launches against the exact "
          f"product of their own operands: worst |err| / tolerance "
          f"{launch_worst:.3e} (at most 1; C = {K2_ORDER_C})")
    print(f"train: {len(convs)} conv weight gradients, relative L2 kernels "
          f"vs plain: median {sorted(rel_kp.values())[len(convs) // 2]:.3e},"
          f" max {max(rel_kp.values()):.3e}; plain f32 vs plain f64 sums "
          f"(the summation-order spread): median "
          f"{sorted(rel_floor.values())[len(convs) // 2]:.3e}, max "
          f"{max(rel_floor.values()):.3e}; worst ratio {over[worst]:.3f} at "
          f"{worst} (at most {TRAIN_GRAD_RATIO}); zero gradients: "
          f"{zero or 'none'}")
    print(f"train: the plain pass repeated: {repeat_bad} gradient elements "
          f"differ (bit-identical required); casts off, f32 vs f64 sums: "
          f"relative L2 median {sorted(rel_off.values())[len(convs) // 2]:.3e}"
          f", max {max(rel_off.values()):.3e}")
    if repeat_bad:
        problems.append(f"the plain pass repeated gave {repeat_bad} other "
                        "gradient elements")
    if len(checked) != 156 or launch_worst > 1.0:
        problems.append(f"{len(checked)} K2 launches checked, worst error "
                        f"{launch_worst} of the bound")
    if over[worst] > TRAIN_GRAD_RATIO:
        problems.append(f"kernel and plain gradients differ by {rel_kp[worst]}"
                        f" at {worst}, {over[worst]} times the f32 / f64 "
                        "spread")
    if zero or len(convs) != 53:
        problems.append(f"{len(convs)} convs, zero gradients at {zero}")
    del grads

    breakdown = profile_train_step(
        lambda: step(params, state, batches[1], prng.fold_in(key, 200)), ms)

    # A forced overflow: a NaN image makes every gradient NaN; the step must
    # leave parameters and momenta bit-identical and halve the scale.
    before = {n: p.detach().clone() for n, p in params.items()}
    momenta = {n: opt.state[p]["momentum_buffer"].clone()
               for n, p in params.items()}
    bad_x = batches[0][0].clone()
    bad_x[0, 0, 0, 0] = float("nan")
    s0 = state[1]
    params, state, bad_loss = step(params, state, (bad_x, batches[0][1]),
                                   prng.fold_in(key, 300))
    same = all(torch.equal(p, before[n]) for n, p in params.items())
    same_m = all(torch.equal(opt.state[p]["momentum_buffer"], momenta[n])
                 for n, p in params.items())
    print(f"train: forced overflow: loss {float(bad_loss)}, scale "
          f"{s0.scale} -> {state[1].scale}, parameters unchanged {same}, "
          f"momenta unchanged {same_m}")
    if not (same and same_m) or state[1] != LossScaleState(s0.scale / 2, 0):
        problems.append("the overflow step was not a true skip")

    record["train"] = {
        "batch": batch, "ms_per_step": ms, "images_per_s": batch / (ms / 1e3),
        "step_ms": [1000 * t for t in times], "peak_bytes": peak,
        "launches_per_step": per_step, "launches": launches,
        "losses": losses, "loss_scale": scales,
        "grad_rel_l2_kernel_vs_plain": rel_kp,
        "grad_rel_l2_plain_f32_vs_f64": rel_floor,
        "grad_rel_l2_casts_off_f32_vs_f64": rel_off,
        "plain_repeat_elements_differing": repeat_bad,
        "launch_err_over_bound": checked,
        "profile": breakdown,
    }
    if problems:
        raise PhaseError("; ".join(problems))
    return launches


# Hand-written kernels of a train step other than K2, by a piece of their
# kernel's name: their time keeps its own part in a train profile.
TRAIN_KERNEL_PARTS = (("adam8_", "P3 8-bit AdamW update (hand-written)"),
                      ("cast_vec", "K1 cast kernel (hand-written)"),
                      ("cast_scalar", "K1 cast kernel (hand-written)"),
                      ("cast_blocked", "K1 cast kernel (hand-written)"))


def own_part(name: str):
    return next((part for key, part in TRAIN_KERNEL_PARTS if key in name),
                None)


def profile_train_step(run, step_ms: float, tag: str = "train"):
    """Device time of one train step by part, from torch.profiler: K2 by
    variant (the forward's implicit-GEMM launches, the backward's dX and
    dW, the pre-passes), P3 and K1, the fake-quant casts and the BatchNorm
    forwards (kernels whose launching op lies inside a range the profiled
    run opens around them), then the rest by kernel name.  Fails if the
    profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from fp8tpu_torch import linen
    from fp8tpu_torch.quant import fakequant

    def ranged(fn, label):
        def inner(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return inner

    cast_impl, bn_forward = fakequant._quantize_impl, linen.BatchNorm.forward
    fakequant._quantize_impl = ranged(cast_impl, "fp8tpu.cast")
    linen.BatchNorm.forward = ranged(bn_forward, "fp8tpu.bn")
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            profile_lead_in()
            run()
            torch.cuda.synchronize()
    finally:
        fakequant._quantize_impl, linen.BatchNorm.forward = \
            cast_impl, bn_forward
    events = p.events()
    cpu = torch.autograd.DeviceType.CPU

    def category(name):
        low = name.lower()
        if "copy" in low or "memcpy" in low or "memset" in low:
            return "copies (im2col, transposes, layouts)"
        if "multi_tensor" in low:
            return "optimizer"
        if any(t in low for t in ("gemm", "cutlass", "cudnn", "xmma",
                                  "conv", "wgrad", "dgrad", "nvjet")):
            return "library conv / GEMM (ResNet stem and fc; decoder Dense)"
        if "reduce" in low:
            return "other reductions"
        return "other elementwise"

    parts = {}

    def add(part, ms, n=1):
        t, c = parts.get(part, (0.0, 0))
        parts[part] = (t + ms, c + n)

    for e in sorted((e for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)
                     and LEAD_KERNEL not in e.name),
                    key=lambda e: e.time_range.start):
        ms = (getattr(e, "device_time", None) or e.cuda_time) / 1000.0
        if own_part(e.name):
            add(own_part(e.name), ms)
        elif "k2_prepass" in e.name:
            add("K2 pre-passes (casts, bf16 planes)", ms)
        elif "k2_gemm<" in e.name:
            # template arguments (A planes, B planes, how A is read): the
            # forward's implicit conv reads the activation's grid (1), dX
            # pre-passed planes (0), dW the transposed im2col as f32 (2)
            how = e.name.split("k2_gemm<")[1].split(">")[0].split(",")[-1]
            add({"1": "K2 forward (hw, implicit GEMM)", "0": "K2 dX",
                 "2": "K2 dW"}.get(how.strip(), "K2 other"), ms)
        else:
            add(category(e.name), ms)
    # Kernels launched by an op inside one of the ranges move from their
    # name's category to the range's part.
    labels = {"fp8tpu.cast":
              "fake-quant casts (weights, activations, gradients, master)",
              "fp8tpu.bn": "BatchNorm forward"}
    moved = 0
    for e in events:
        if e.device_type != cpu or getattr(e, "is_user_annotation", False):
            continue
        op, label = e.cpu_parent, None
        while op is not None and label is None:
            label = labels.get(op.name)
            op = op.cpu_parent
        if label is None:
            continue
        for kern in getattr(e, "kernels", None) or []:
            if own_part(kern.name):
                continue
            ms = kern.duration / 1000.0
            add(label, ms)
            add(category(kern.name), -ms, -1)
            moved += 1
    if not moved:
        print(f"{tag} profile: no kernel could be traced to its range; casts "
              "and BatchNorm stay in the elementwise and reduction parts")
    busy = sum(t for t, _ in parts.values())
    if not busy > 0:
        raise PhaseError("torch.profiler recorded no device time")
    print(f"{tag} profile: one step, {busy:.2f} ms of kernels on the device "
          f"against {step_ms:.2f} ms per step (busy share "
          f"{busy / step_ms:.3f}):")
    for part, (t, n) in sorted(parts.items(), key=lambda kv: -kv[1][0]):
        print(f"  {t:9.3f} ms {n:5d}x  {part}")
    return {"device_ms": busy, "step_ms": step_ms,
            "parts": {k: {"ms": t, "count": n}
                      for k, (t, n) in parts.items()}}


# -- phases p3 and train_lm: decoder FP8 training with the 8-bit AdamW ---------

# The JAX package's "large" decoder (tools/accuracy_gates.py:56-58, the
# 82.8M-parameter model of ACCURACY_BUDGET.json): 12 layers, d_model 768,
# 12 / 4 heads, d_ff 2304, vocabulary 256, sequences of 256 tokens, batch
# 32 (tools/gemm_recipe.py:21); bf16 compute, f32 parameters.
LM = dict(vocab_size=256, d_model=768, n_layers=12, n_heads=12, n_kv_heads=4,
          d_ff=2304, max_seq_len=256)
LM_BATCH = 32
LM_STEPS = 4                   # timed steps, after one warm-up step
LM_LR = 1e-3                   # adamw_8bit (the large preset's lr)
LM_REMAT_ATOL = 4e-3           # remat vs not: a bf16 step (tests/test_remat.py)
LM_HW_LAYERS = 2               # the hw-patched run's depth
LM_HW_BATCH = 8                # and batch (its engine runs a GEMM a slice)
LM_LOSS_RTOL = 1e-5            # PERF.md §2's 3-step gate
BENCH_GATE = (4096, 11008)     # bench.py's CFG, the gate projection


def p3_bytes(n: int) -> float:
    """Bytes P3 must move on a leaf of n f32 elements: p, g, both payloads
    and both scales read once; p, the payloads and the scales written
    once."""
    nb = -(-n // 256)
    return 12.0 * n + 4.0 * nb * 256 + 16.0 * nb


def lm_shapes():
    """(name, shape, Dense?) of every parameter of the large decoder, from a
    model on the meta device."""
    import torch
    from fp8tpu_torch.linen import Dense
    from fp8tpu_torch.models.transformer import Decoder, DecoderConfig
    with torch.device("meta"):
        model = Decoder(DecoderConfig(**LM))
    dense = {n for n, m in model.named_modules() if isinstance(m, Dense)}
    return [(n, tuple(p.shape), n.rpartition(".")[0] in dense)
            for n, p in model.named_parameters()]


def p3_case(gen, shape, lo=-18.0, hi=0.0, warm=3, zero_block=False):
    """A leaf (p, g) and its 8-bit state ``warm`` steps in (made by the
    kernel, so the state is what a run carries), on the card."""
    import torch
    from fp8tpu_torch.kernels import adam8
    n = math.prod(shape)
    nb = -(-n // adam8.BLOCK)
    st = [torch.zeros((nb, 256), dtype=torch.int8, device="cuda"),
          torch.zeros(nb, device="cuda"),
          torch.zeros((nb, 256), dtype=torch.float8_e4m3fn, device="cuda"),
          torch.zeros(nb, device="cuda")]

    def grad():
        g = torch.randn(shape, device="cuda", generator=gen) * torch.exp(
            torch.empty(shape, device="cuda").uniform_(lo, hi, generator=gen))
        if zero_block:
            g.view(-1)[:256] = 0.0
        return g

    for c in range(1, warm + 1):
        args = adam8.Adam8Args(0.9, 0.999, 1e-8,
                               *adam8.bias_corrections(0.9, 0.999, c))
        adam8.adam8_update(torch.empty(shape, device="cuda"), grad(), *st,
                           args, "store")
    p = torch.randn(shape, device="cuda", generator=gen)
    return p, grad(), st


def p3_views(p, g, view):
    """(p, g) as P3 is to take them: ``view`` True the transposed view (a
    Dense weight in (in, out) order), "unaligned" copies 4 bytes past a
    16-byte boundary (the strided walk over one row), else as they are."""
    import torch
    if view == "unaligned":
        def shifted(t):
            buf = torch.empty(t.numel() + 1, device=t.device)
            return buf[1:].view(t.shape).copy_(t)
        return shifted(p), shifted(g)
    if view:
        return p.t(), g.t()
    return p, g


def p3_against_plain(p, g, st, args, mode, view=False, cpu=False):
    """Launch P3 on copies of (p, g, state) and the plain version on others
    (on the card, and with ``cpu`` also on the CPU): the number of
    differing bytes of p and of each state tensor, each plain run against
    the kernel, the walk, and the blocks of each route [fast, slow]."""
    import torch
    from fp8tpu_torch.kernels import adam8
    pk, gk = p3_views(p.clone(), g.clone(), view)
    sk = [t.clone() for t in st]
    routes = torch.zeros(2, dtype=torch.int64, device="cuda")
    adam8.adam8_update(pk, gk, *sk, args, mode, routes=routes)
    out = {"walk": adam8.walk_of(pk, gk), "routes": routes.tolist()}
    for label, dev in [("card", "cuda")] + ([("cpu", "cpu")] if cpu else []):
        pp, gp = p.to(dev).clone(), g.to(dev).clone()
        sp = [t.to(dev).clone() for t in st]
        if view is True:
            pp, gp = pp.t(), gp.t()
        adam8.adam8_update_plain(pp, gp, *sp, args, mode)
        out[label] = [bytes_differ(pk, pp)] + [
            bytes_differ(a, b) for a, b in zip(sk, sp)]
    return out


def bytes_differ(a, b) -> int:
    """Number of differing bytes of two tensors of one dtype and shape (on
    any devices)."""
    import torch
    a = a.detach().contiguous().reshape(-1).view(torch.uint8)
    b = b.detach().contiguous().reshape(-1).view(torch.uint8).to(a.device)
    return int((a != b).sum())


def p3_forced(gen, kind):
    """A (4096,) leaf three steps in whose second block is made to take
    P3's slow route by ``kind`` (every other block takes the fast one)."""
    import torch
    p, g, st = p3_case(gen, (4096,))
    if kind == "NaN g":
        g[300] = float("nan")
    elif kind == "inf g":
        g[300] = -float("inf")
    elif kind == "|g| over 2^60":
        g[300] = 2.0 ** 61
    elif kind == "|p| over 2^100":
        p[300] = -(2.0 ** 101)
    elif kind == "subnormal old scale":
        st[1][1] = 1e-40
    elif kind == "NaN code in old v":
        st[2].view(torch.uint8)[1, 44] = 0x7F
    else:
        raise ValueError(kind)
    return p, g, st


# The fast route's divides and convert over every f32 input: the bias
# corrections of these counts (b1 0.9, b2 0.999) and block scales spread
# over the route's range.
P3_PROBE_COUNTS = range(1, 11)
P3_PROBE_SCALES = tuple(m * 2.0 ** e for e in range(-86, 121, 8)
                        for m in (1.0, 1.3787811, 1.9999999))


def p3_run_divisors(b1=0.9, b2=0.999):
    """Every distinct f32 bias correction (bc1 and bc2) that a run with
    ``b1``, ``b2`` takes below 1, from count 1 up to the count where both
    round to 1."""
    from fp8tpu_torch.kernels import adam8
    seen, count = set(), 1
    while True:
        bcs = adam8.bias_corrections(b1, b2, count)
        seen.update(bc for bc in bcs if bc < 1.0)
        if min(bcs) == 1.0:
            return sorted(seen), count
        count += 1


def p3_probes():
    """(rows, problems): each probe of ``adam8.probe`` with its inputs
    taken and differing (0 differing required)."""
    from fp8tpu_torch.kernels import adam8
    rows, problems = [], []
    jobs = [("quot_bc", bc, f"bc{i + 1} of count {c}")
            for c in P3_PROBE_COUNTS
            for i, bc in enumerate(adam8.bias_corrections(0.9, 0.999, c))]
    jobs += [(kind, s, f"block scale {s!r}") for s in P3_PROBE_SCALES
             for kind in ("int8_code", "e4m3_code")]
    jobs.append(("e4m3_convert", 1.0, "every f32"))
    jobs.append(("flush", 1.0, "every f32 but NaNs"))
    divs, last = p3_run_divisors()
    jobs.append(("quot_bc_significands", divs,
                 f"every bc1 / bc2 of counts 1-{last} ({len(divs)} "
                 f"distinct)"))
    for kind, s, label in jobs:
        taken, bad, first = adam8.probe(kind, s)
        rows.append({"probe": kind, "divisor": s if isinstance(s, float)
                     else len(s), "label": label, "taken": taken,
                     "differ": bad, "first": first})
        if bad:
            d = s if isinstance(s, float) else s[first[0]]
            problems.append(f"probe {kind} {label}: {bad} of {taken} differ"
                            f" (first 0x{first[1]:08x} by {d!r})")
    return rows, problems


def phase_p3(record):
    """P3 (the 8-bit AdamW update) against its plain version, bit for bit:
    odd sizes, a zero block, subnormal-range gradients, the weight decay
    with and without a mask, the store mode, a Dense weight through its
    transposed view (the tile walk) and through one the tile does not
    take, an unaligned leaf; blocks forced onto the slow route by their
    data (NaN or inf g, |g| or |p| over the fast route's limits, a
    subnormal old scale, a NaN code) beside fast ones; every leaf of the
    large decoder and one (4096, 11008) leaf; the large decoder's leaves in
    one grouped launch.  Then the fast route's divides and convert over
    every f32 input, and its divide by every bias correction of a run over
    every significand (``p3_probes``), and P3's time on the gate leaf and on
    one step's 110 leaves of the large decoder (one grouped launch, a
    launch a leaf, the leaves read contiguously), beside the byte bound,
    the plain version and, as a yardstick of another function,
    torch.optim.AdamW(fused=True); with ``parent`` (a tree holding the
    parent commit), the parent's P3 on the same leaves in turns."""
    import torch
    from fp8tpu_torch.kernels import adam8
    from fp8tpu_torch.tools import device_ms

    gen = torch.Generator(device="cuda").manual_seed(7)
    args = adam8.Adam8Args(0.9, 0.999, 1e-8,
                           *adam8.bias_corrections(0.9, 0.999, 4),
                           weight_decay=1e-4, neg_lr=-LM_LR)
    # (label, shape, p3_case keywords, mode, view, walk, slow blocks)
    cases = [("1 element", (1,), {}, "apply", False, "vector", 0),
             ("255", (255,), {}, "apply_decay", False, "vector", 0),
             ("257", (257,), {}, "apply", False, "vector", 0),
             ("(300, 257)", (300, 257), {}, "apply_decay", False, "vector",
              0),
             ("(7, 11, 3) store", (7, 11, 3), {}, "store", False, "vector",
              0),
             ("a zero block", (1024,), {"zero_block": True}, "apply_decay",
              False, "vector", 0),
             ("subnormal g*g", (4096,), {"lo": -60.0, "hi": -40.0},
              "apply_decay", False, "vector", 0),
             ("wide g", (4096,), {"lo": -40.0, "hi": 20.0}, "apply", False,
              "vector", None),
             ("Dense (768, 2304) via (in, out) view", (2304, 768), {},
              "apply_decay", True, "tile", 0),
             ("(300, 257) unaligned", (300, 257), {}, "apply_decay",
              "unaligned", "strided", 0),
             ("Dense (300, 64) via view, rows not of 256", (300, 64), {},
              "apply_decay", True, "strided", 0),
             ("Dense (256, 96) via view, tile store", (256, 96), {},
              "store", True, "tile", 0)]
    problems, rows = [], []
    for label, shape, kw, mode, view, walk, slow in cases:
        p, g, st = p3_case(gen, shape, **kw)
        got = p3_against_plain(p, g, st, args, mode, view, cpu=True)
        rows.append({"case": label, **got})
        bad = {k: sum(got[k]) for k in ("card", "cpu")}
        print(f"p3 {label} ({mode}, {got['walk']} walk, blocks fast / slow "
              f"{got['routes']}): differing bytes against plain on the card "
              f"/ CPU: {bad['card']} / {bad['cpu']}")
        if any(bad.values()) or got["walk"] != walk or (
                slow is not None and got["routes"][1] != slow):
            problems.append(f"{label}: {got}")
    for kind in ("NaN g", "inf g", "|g| over 2^60", "|p| over 2^100",
                 "subnormal old scale", "NaN code in old v"):
        p, g, st = p3_forced(gen, kind)
        got = p3_against_plain(p, g, st, args, "apply_decay", cpu=True)
        rows.append({"case": f"forced slow: {kind}", **got})
        # the CPU decides a NaN's sign (trap 10): the card's plain version
        # writes the device's NaN
        print(f"p3 forced slow block: {kind}: blocks fast / slow "
              f"{got['routes']}, differing bytes against plain on the card /"
              f" CPU: {sum(got['card'])} / {sum(got['cpu'])}")
        if sum(got["cpu"]) or got["routes"] != [15, 1]:
            problems.append(f"forced slow {kind}: {got}")

    # every leaf of the large decoder (Dense weights through their view),
    # masked decay (norm scales undecayed), and the gate leaf
    leaves = lm_shapes()
    worst, walks = 0, {}
    for name, shape, dense in leaves + [("bench.py gate", BENCH_GATE,
                                         False)]:
        p, g, st = p3_case(gen, shape, warm=1)
        mode = "apply" if name.endswith(".scale") else "apply_decay"
        got = p3_against_plain(p, g, st, args, mode, view=dense)
        walks[got["walk"]] = walks.get(got["walk"], 0) + 1
        worst = max(worst, sum(got["card"]))
        if sum(got["card"]):
            problems.append(f"leaf {name}: {got}")
    print(f"p3: all {len(leaves)} leaves of the large decoder and the "
          f"{BENCH_GATE} leaf against the plain version on the card: "
          f"{worst} differing bytes at most (0 required); walks {walks}")

    # the large decoder's leaves in one grouped launch, against plain
    leaf_state = [(*p3_case(gen, shape, warm=1), dense,
                   "apply" if name.endswith(".scale") else "apply_decay")
                  for name, shape, dense in leaves]

    def grouped(state):
        return [adam8.Leaf(*p3_views(p, g, dense), *st, mode=mode)
                for p, g, st, dense, mode in state]

    copies = [(p.clone(), g.clone(), [t.clone() for t in st], dense, mode)
              for p, g, st, dense, mode in leaf_state]
    routes = torch.zeros(2, dtype=torch.int64, device="cuda")
    adam8.reset_launches()
    adam8.adam8_update_many(grouped(copies), args, routes=routes)
    group_launches = (adam8.launches, adam8.leaves_covered)
    group_bad = 0
    for (p, g, st, dense, mode), (pk, _, sk, _, _) in zip(leaf_state,
                                                          copies):
        pp, gp = p3_views(p.clone(), g.clone(), dense)
        sp = [t.clone() for t in st]
        adam8.adam8_update_plain(pp, gp, *sp, args, mode)
        group_bad += bytes_differ(pk, pp.t() if dense else pp) + sum(
            bytes_differ(a, b) for a, b in zip(sk, sp))
    print(f"p3: the large decoder's {len(leaves)} leaves in one grouped "
          f"launch (launches, leaves covered {group_launches}; blocks fast /"
          f" slow {routes.tolist()}): {group_bad} differing bytes against "
          f"the plain version on the card (0 required)")
    if group_bad or group_launches != (1, len(leaves)):
        problems.append(f"grouped launch: {group_bad} bytes, "
                        f"{group_launches}")
    del copies

    probe_rows, probe_problems = p3_probes()
    problems += probe_problems
    print(f"p3: {len(probe_rows) - 1} probes of the fast route over every "
          f"f32 input (bc1 / bc2 of counts {P3_PROBE_COUNTS.start}-"
          f"{P3_PROBE_COUNTS.stop - 1}, {len(P3_PROBE_SCALES)} block scales "
          f"in [2^-86, 2^121), the convert, the flush) and one over every "
          f"significand ({probe_rows[-1]['label']}): "
          f"{sum(r['differ'] for r in probe_rows)} differing of "
          f"{sum(r['taken'] for r in probe_rows)} inputs taken (0 required)")

    # times: the gate leaf, and one step's leaves of the large decoder
    timed = {}
    gp, gg, gst = p3_case(gen, BENCH_GATE, warm=1)
    n = gp.numel()
    timed["gate"] = {
        "n": n, "ms": device_ms(lambda: adam8.adam8_update(
            gp, gg, *gst, args, "apply_decay"), iters=4, replays=3),
        "plain_ms": cuda_ms(lambda: adam8.adam8_update_plain(
            gp, gg, *gst, args, "apply_decay"), iters=2, warmup=1),
        "bound_ms": p3_bytes(n) / HBM_BYTES_PER_S * 1e3}
    fused = torch.optim.AdamW([gp.clone().requires_grad_(True)], lr=LM_LR,
                              fused=True, capturable=True)
    fused.param_groups[0]["params"][0].grad = gg.clone()
    fused.step()
    timed["gate"]["fused_adamw_ms"] = device_ms(fused.step, iters=4,
                                                replays=3)
    del fused
    table = adam8.leaf_table(grouped(leaf_state))

    def step_all():
        adam8.adam8_update_many(grouped(leaf_state), args, table)

    def per_leaf():
        for lf in grouped(leaf_state):
            adam8.adam8_update(*lf[:6], args, lf.mode)

    def plain_all():
        for lf in grouped(leaf_state):
            adam8.adam8_update_plain(*lf[:6], args, lf.mode)

    flat = [(p, g, st, False, mode) for p, g, st, _, mode in leaf_state]
    flat_table = adam8.leaf_table(grouped(flat))
    ps = [x[0].clone().requires_grad_(True) for x in leaf_state]
    for q, x in zip(ps, leaf_state):
        q.grad = x[1].clone()
    fused = torch.optim.AdamW(ps, lr=LM_LR, fused=True, capturable=True)
    fused.step()
    n = sum(x[0].numel() for x in leaf_state)
    timed["large_step"] = {
        "n": n, "leaves": len(leaf_state),
        "ms": device_ms(step_all, iters=2, replays=3),
        "ms_launch_a_leaf": device_ms(per_leaf, iters=2, replays=3),
        "ms_no_views": device_ms(lambda: adam8.adam8_update_many(
            grouped(flat), args, flat_table), iters=2, replays=3),
        "plain_ms": cuda_ms(plain_all, iters=1, warmup=1),
        "bound_ms": sum(p3_bytes(x[0].numel()) for x in leaf_state)
        / HBM_BYTES_PER_S * 1e3,
        "fused_adamw_ms": device_ms(fused.step, iters=2, replays=3)}
    del ps, fused
    for k, t in timed.items():
        print(f"time p3 {k} ({t['n']} elements): kernel {t['ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f} ms, bytes bound {t['bound_ms']:.4f}"
              f" ms ({t['bound_ms'] / t['ms']:.3f} of it); yardstick "
              f"torch.optim.AdamW(fused=True), f32 moments, another function:"
              f" {t['fused_adamw_ms']:.4f} ms"
              + (f"; a launch a leaf {t['ms_launch_a_leaf']:.4f} ms; leaves "
                 f"read contiguously {t['ms_no_views']:.4f} ms"
                 if "ms_no_views" in t else ""))
    del leaf_state, flat, gp, gg, gst
    record["p3"] = {"cases": rows, "leaves_worst": worst, "walks": walks,
                    "grouped_bad": group_bad, "probes": probe_rows,
                    "time": timed}
    if problems:
        raise PhaseError("; ".join(problems[:6]))
    t = timed["large_step"]
    return [{"name": "adam8_update (P3, 8-bit AdamW update; times: one "
                     "step's 110 leaves of the large decoder, one grouped "
                     "launch)",
             "route": "cuda", "source": "fp8tpu_torch/kernels/csrc/adam8.cu",
             "replaces": "fp8tpu/training/opt8.py:104 (XLA ops, no TPU "
                         "kernel)",
             "launches": None, "max_abs_err": 0.0, "ms": t["ms"],
             "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
             "bound_by": "bytes", "library_ms": None}]


def lm_loss(model):
    """Next-token cross entropy of the decoder on batch[:, :-1] -> batch[:,
    1:] (the JAX package's lm_loss), plus the poison of a (tokens, poison)
    batch, which a forced overflow sets to NaN."""
    import torch.nn.functional as F

    def loss_fn(apply_fn, params, batch):
        toks, poison = batch if isinstance(batch, tuple) else (batch, None)
        logits = apply_fn(params, toks[:, :-1])
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               toks[:, 1:].reshape(-1))
        return loss if poison is None else loss * poison
    return loss_fn


def lm_share_loss(global_tokens: int):
    """The data-parallel form of lm_loss (examples/train_fp8.py's): this
    rank's tokens' summed cross entropy over the global batch's count."""
    import torch
    import torch.nn.functional as F

    def loss_fn(apply_fn, params, batch):
        logits = apply_fn(params, batch[:, :-1])
        return F.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), batch[:, 1:].reshape(-1),
            reduction="sum") / torch.tensor(float(global_tokens),
                                            device=logits.device)
    return loss_fn


def lm_trainer(n_layers=LM["n_layers"], remat=False, algo="hybrid-gemm",
               emb="e4m3", hw=False, seed=0, shard=None):
    """examples/train_fp8.py's setup on the card: a random decoder from a
    seed, initialize(training_algo, master fp16, emb_fmt), adamw_8bit,
    make_train_step with loss scale 2^12; with a BatchShard, the script's
    data-parallel step (each rank's batch is its rows of LM_BATCH)."""
    import dataclasses
    import torch
    import fp8tpu_torch as ft
    from fp8tpu_torch.models import decoder
    from fp8tpu_torch.models.transformer import DecoderConfig
    from fp8tpu_torch.training import (adamw_8bit, init_train_state,
                                       make_train_step)
    cfg = DecoderConfig(**{**LM, "n_layers": n_layers, "remat": remat})
    model = decoder(cfg, generator=torch.Generator().manual_seed(seed))
    emu = ft.initialize(model, training_algo=algo, master_fmt="fp16",
                        emb_fmt=emb)
    if hw:
        emu = dataclasses.replace(emu, policy=emu.policy.with_hw_patching())
    params = dict(model.named_parameters())
    opt = adamw_8bit(params, LM_LR, module_table=emu.module_table)
    loss = (lm_loss(model) if shard is None
            else lm_share_loss(LM_BATCH * (LM["max_seq_len"] - 1)))
    return (model, emu, params, opt,
            make_train_step(emu, loss, loss_scale=2.0 ** 12, shard=shard),
            init_train_state(opt, 2.0 ** 12))


def lm_batches(n: int, seed: int = 0):
    import torch
    from fp8tpu_torch.data.synthetic import mixed_lm_corpus
    toks = mixed_lm_corpus(n * LM_BATCH, LM["max_seq_len"], LM["vocab_size"],
                           seed=seed)
    return [torch.from_numpy(toks[i * LM_BATCH:(i + 1) * LM_BATCH]).long()
            .to("cuda") for i in range(n)]


def lm_run(step, params, state, batches, key, opt=None):
    """The steps, timed: (params, state, losses, seconds a step, per step
    the launches of P3 and K1 and, with the 8-bit ``opt``, its
    :func:`v_underflow` and :func:`nan_codes` counts)."""
    import torch
    from fp8tpu_torch.kernels import adam8, cast_kernel
    from fp8tpu_torch.numerics import prng
    losses, times, per_step = [], [], []
    for i, b in enumerate(batches):
        p0, l0 = adam8.launches, adam8.leaves_covered
        k0 = cast_kernel.launches
        t = time.perf_counter()
        params, state, loss = step(params, state, b, prng.fold_in(key, i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(float(loss))
        per_step.append({"launches": {"adam8": adam8.launches - p0,
                                      "adam8_leaves": adam8.leaves_covered
                                      - l0,
                                      "cast_kernel": cast_kernel.launches
                                      - k0},
                         "v_underflow": None if opt is None
                         else v_underflow(opt),
                         "v_nan": None if opt is None else sum(
                             nan_codes(st["v"].payload)
                             for st in opt.state.values())})
    return params, state, losses, times, per_step


def nan_codes(payload) -> int:
    """e4m3 NaN codes (0x7F / 0xFF) in a payload."""
    import torch
    return int(((payload.view(torch.uint8) & 0x7F) == 0x7F).sum())


def v_underflow(opt) -> int:
    """Elements whose 8-bit second moment is 0 while the first is not: each
    takes an update of lr * m / eps (the 8-bit AdamW's blow-up, ROADMAP
    trap 67)."""
    import torch
    return sum(int((((st["v"].payload.view(torch.uint8) & 0x7F) == 0)
                    & (st["m"].payload != 0)).sum())
               for st in opt.state.values())


def phase_train_lm(record):
    """Decoder FP8 training as examples/train_fp8.py runs it
    (--training-algo hybrid-gemm --master-fmt fp16 --opt8 --emb-fmt e4m3)
    at the large preset's full width."""
    import torch
    from fp8tpu_torch.kernels import adam8, cast_kernel
    from fp8tpu_torch.numerics import cast as cast_mod
    from fp8tpu_torch.numerics import prng
    from fp8tpu_torch.training import LossScaleState, opt8, state_bytes
    from fp8tpu_torch.utils import (MetricLogger, restore_checkpoint,
                                    save_checkpoint)

    problems = []
    key = prng.key(1)
    batches = lm_batches(1 + LM_STEPS)
    tokens = LM_BATCH * (LM["max_seq_len"] - 1)
    model, emu, params, opt, step, state = lm_trainer()
    n_params = sum(p.numel() for p in params.values())
    leaves = len(params)

    # The main path: 1 warm-up and LM_STEPS timed steps, counted, with no
    # plain version of P3 or K1 allowed.
    adam8.reset_launches()
    cast_kernel.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _Counting(adam8, "adam8_update_plain", forbid=True), \
            _Counting(cast_mod, "qdq_plain", forbid=True):
        params, state, losses, times, per_step = lm_run(
            step, params, state, batches, key, opt)
    launches = {"adam8_update": adam8.launches,
                "adam8_leaves": adam8.leaves_covered,
                "cast_kernel": cast_kernel.launches}
    peak = torch.cuda.max_memory_allocated()
    after_run = {n: p.detach().clone() for n, p in params.items()}
    ms = 1000.0 * sum(times[1:]) / LM_STEPS
    log = MetricLogger()
    for loss, t in zip(losses[1:], times[1:]):
        log.update(loss=loss, tokens_per_s=tokens / t)
    opt8_bytes = state_bytes(opt)
    adamw_bytes = sum(8 * p.numel() + 4 for p in params.values())
    print(f"train_lm: decoder {LM['n_layers']} layers, d_model "
          f"{LM['d_model']}, {n_params} parameters, hybrid-gemm, fp16 "
          f"master, emb e4m3, adamw_8bit; batch {LM_BATCH} x "
          f"{LM['max_seq_len'] - 1} tokens: {ms:.2f} ms/step, "
          f"{tokens / (ms / 1e3):.1f} tokens/s (warm-up "
          f"{1000 * times[0]:.1f} ms; steps "
          f"{', '.join(f'{1000 * t:.2f}' for t in times[1:])} ms); peak "
          f"device memory {peak / 2 ** 30:.3f} GiB")
    print(f"train_lm: optimizer state {opt8_bytes} bytes (8-bit) against "
          f"{adamw_bytes} for torch.optim.AdamW's f32 moments and steps "
          f"({adamw_bytes / opt8_bytes:.2f}x)")
    print(f"train_lm: launches per step {[p['launches'] for p in per_step]}"
          f"; losses {', '.join(f'{v:.4f}' for v in losses)}; elements "
          f"with v = 0 and m != 0 after each step "
          f"{[p['v_underflow'] for p in per_step]}, e4m3 NaN codes in v "
          f"{[p['v_nan'] for p in per_step]}; no plain version "
          f"called; MetricLogger: {log}")
    # one grouped P3 launch a step covers every leaf
    want = {"adam8": 1, "adam8_leaves": leaves, "cast_kernel": 1}
    if any(p["launches"] != want for p in per_step):
        problems.append(f"launches per step {per_step}, expected {want}")
    if not all(map(math.isfinite, losses)):
        problems.append(f"losses not finite: {losses}")
    if state[1] != LossScaleState(2.0 ** 12, 1 + LM_STEPS):
        problems.append(f"loss scale {state[1]}: the steps were to be clean")

    # remat: the same steps from the same weights, each layer recomputed
    # in the backward
    del model, emu, params, opt, step, state
    torch.cuda.empty_cache()
    _, _, rparams, ropt, rstep, rstate = lm_trainer(remat=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rparams, rstate, rlosses, rtimes, _ = lm_run(rstep, rparams, rstate,
                                                 batches, key)
    rpeak = torch.cuda.max_memory_allocated()
    far = sum(int((~torch.isclose(rparams[n].detach(), after_run[n], rtol=0,
                                   atol=LM_REMAT_ATOL, equal_nan=True))
                   .sum()) for n in rparams)
    rms = 1000.0 * sum(rtimes[1:]) / LM_STEPS
    same = [a == b or (math.isnan(a) and math.isnan(b))
            for a, b in zip(rlosses, losses)]
    print(f"train_lm: remat: losses {'equal' if all(same) else rlosses}, "
          f"{far} parameters further than {LM_REMAT_ATOL} from the main "
          f"run's (0 required); {rms:.2f} ms/step, peak device memory "
          f"{rpeak / 2 ** 30:.3f} GiB against {peak / 2 ** 30:.3f}")
    if not all(same) or far:
        problems.append(f"remat: losses {rlosses} vs {losses}, {far} "
                        "parameters apart")
    del rparams, ropt, rstep, rstate, after_run
    torch.cuda.empty_cache()

    # From a fresh trainer (the same seed): one step profiled, one step
    # with every P3 launch held against the plain version on the card on
    # the launch's own operands, a forced overflow, the checkpoint.
    model, emu, params, opt, step, state = lm_trainer()
    breakdown = profile_train_step(
        lambda: step(params, state, batches[1], prng.fold_in(key, 60)),
        ms, tag="train_lm")
    checked, on_card, leaf_stats, grouped = [], [], [], []
    launch = opt8.adam8_update_many
    nan_before = sum(nan_codes(st["v"].payload) for st in opt.state.values())

    def checking(leaves_, args, table=None, routes=None):
        # every leaf of the step's grouped launch against the plain version
        # on its own operands
        ins = [[lf.p.contiguous().clone(), lf.g.contiguous().clone()]
               + [t.clone() for t in lf[2:6]] for lf in leaves_]
        before = (adam8.launches, adam8.leaves_covered)
        out = launch(leaves_, args, table, routes)
        grouped.append((adam8.launches - before[0],
                        adam8.leaves_covered - before[1]))
        for lf, leaf_in in zip(leaves_, ins):
            got = [lf.p, *lf[2:6]]
            leaf_stats.append({
                "name": opt.names[len(leaf_stats)],
                "g_absmax": float(lf.g.abs().max()),
                "g_nonfinite": int((~torch.isfinite(lf.g)).sum()),
                "v_scale_max": [float(leaf_in[5].max()), float(lf.vs.max())],
                "v_nan": [nan_codes(leaf_in[4]), nan_codes(lf.vq)]})

            def against(ref):
                adam8.adam8_update_plain(*ref, args, lf.mode)
                return sum(bytes_differ(a, b)
                           for a, b in zip(got, ref[:1] + ref[2:]))

            on_card.append(against([t.clone() for t in leaf_in]))
            # The plain version on the card makes its NaNs by the device's
            # rules (inf / inf is 0x7FFFFFFF there); P3 follows the host's
            # (trap 10), so the plain version on the CPU decides.
            checked.append(against([t.cpu() for t in leaf_in]) if on_card[-1]
                           else 0)
        return out

    opt8.adam8_update_many = checking
    try:
        params, state, loss = step(params, state, batches[2],
                                   prng.fold_in(key, 50))
        torch.cuda.synchronize()
    finally:
        opt8.adam8_update_many = launch
    print(f"train_lm: one step's P3 launches (launches, leaves covered) "
          f"{grouped} (loss {float(loss):.4f}), each of its {len(checked)} "
          f"leaves against the plain version on its own operands: "
          f"{sum(on_card)} differing bytes on the card, of which "
          f"{sum(checked)} against the plain version on the CPU, which "
          f"decides (0 required)")
    # Where the step's NaN codes come from: the trainer's state before it
    # (this trainer took one step, the profiled one) and each leaf's
    # gradient and v scale.
    top = sorted(leaf_stats, key=lambda r: -r["g_absmax"])[:3]
    nan_leaves = [r for r in leaf_stats if r["v_nan"] != [0, 0]]
    print(f"train_lm: the checked step (the trainer's second): e4m3 NaN "
          f"codes in v before it {nan_before}; largest |g| "
          + ", ".join(f"{r['name']} {r['g_absmax']:.6g}" for r in top)
          + f"; non-finite g {sum(r['g_nonfinite'] for r in leaf_stats)}"
          + f"; largest v scale before / after "
          f"{max(r['v_scale_max'][0] for r in leaf_stats):.6g} / "
          f"{max(r['v_scale_max'][1] for r in leaf_stats):.6g}; leaves with "
          f"NaN codes (before, after): "
          + (", ".join(f"{r['name']} {r['v_nan']} (|g| "
                       f"{r['g_absmax']:.6g}, v scale {r['v_scale_max']})"
                       for r in nan_leaves) or "none"))
    if (grouped != [(1, leaves)] or len(checked) != leaves
            or sum(checked)):
        problems.append(f"P3 on the main path: launches {grouped}, "
                        f"{len(checked)} leaves checked, {sum(checked)} "
                        f"differing bytes")

    # A forced overflow: parameters, moments and count untouched, the
    # scale halved.
    before = {n: p.detach().clone() for n, p in params.items()}
    moments = {n: [t.clone() for w in ("m", "v") for t in opt.state[p][w]]
               for n, p in params.items()}
    count, s0 = opt.count, state[1]
    poison = torch.tensor(float("nan"), device="cuda")
    params, state, bad = step(params, state, (batches[0], poison),
                              prng.fold_in(key, 70))
    moved = sum(bytes_differ(p, before[n]) for n, p in params.items())
    moved_m = sum(bytes_differ(a, b) for n, p in params.items()
                  for a, b in zip([t for w in ("m", "v")
                                   for t in opt.state[p][w]], moments[n]))
    print(f"train_lm: forced overflow: loss {float(bad)}, scale {s0.scale} "
          f"-> {state[1].scale}, bytes changed: parameters {moved}, 8-bit "
          f"moments {moved_m}; count {count} -> {opt.count}")
    if moved or moved_m or opt.count != count or state[1] != \
            LossScaleState(s0.scale / 2, 0):
        problems.append("the overflow step was not a true skip")
    del before, moments

    # The checkpoint: this state through disk and back into another
    # trainer, bit for bit.
    ck = os.path.join("chip_smoke_out", "lm_checkpoint")
    save_checkpoint(ck, opt.count, params, (opt, state[1]),
                    policy=emu.policy)
    size = os.path.getsize(os.path.join(ck, f"state_{opt.count}.npz"))
    _, _, fresh, fopt, _, _ = lm_trainer(seed=1)
    res = restore_checkpoint(ck, opt.count, {
        "params": fresh, "opt_state": (fopt, LossScaleState(1.0))})
    out, policy = res["state"], res["meta"]["policy"]
    bad_ck = sum(bytes_differ(out["params"][n], p)
                 for n, p in params.items())
    bad_ck += sum(bytes_differ(a, b)
                  for n, p in params.items()
                  for w in ("m", "v")
                  for a, b in zip(opt.state[p][w],
                                  fopt.state[fresh[n]][w]))
    print(f"train_lm: checkpoint round trip ({size / 2 ** 20:.1f} MiB): "
          f"{bad_ck} differing bytes, count {fopt.count}, loss scale "
          f"{out['opt_state'][1]}, policy equal {policy == emu.policy}")
    if (bad_ck or fopt.count != opt.count or out["opt_state"][1] != state[1]
            or policy != emu.policy):
        problems.append("the checkpoint did not restore bit for bit")
    import shutil
    shutil.rmtree(ck, ignore_errors=True)
    del fresh, fopt, out, res, model, emu, params, opt, step, state
    torch.cuda.empty_cache()

    hw = lm_hw_patched(batches[0][:LM_HW_BATCH], key)
    record["train_lm"] = {
        "config": LM, "batch": LM_BATCH, "parameters": n_params,
        "ms_per_step": ms, "tokens_per_s": tokens / (ms / 1e3),
        "step_ms": [1000 * t for t in times], "peak_bytes": peak,
        "state_bytes_opt8": opt8_bytes, "state_bytes_adamw": adamw_bytes,
        "per_step": per_step, "launches": launches, "losses": losses,
        "p3_checked": checked, "p3_leaves": leaf_stats,
        "p3_checked_launches": grouped,
        "p3_checked_on_card": on_card,
        "profile": breakdown,
        "remat": {"losses": rlosses, "params_apart": far,
                  "ms_per_step": rms, "peak_bytes": rpeak},
        "hw": hw, "metric_logger": str(log)}
    problems += hw.pop("problems")
    if problems:
        raise PhaseError("; ".join(problems))
    return launches


def phase_train_lm_control(record):
    """A control, not the port's path: train_lm's steps from the same seed
    with the 8-bit AdamW and with torch.optim.AdamW's f32 moments in its
    place (ROADMAP trap 67)."""
    import torch
    from fp8tpu_torch.numerics import prng
    from fp8tpu_torch.training import init_train_state
    key = prng.key(1)
    batches = lm_batches(1 + LM_STEPS)
    _, _, params, opt, step, state = lm_trainer()
    _, _, losses, _, per_step = lm_run(step, params, state, batches, key,
                                       opt)
    del params, opt, step, state
    torch.cuda.empty_cache()
    _, _, cparams, _, cstep, _ = lm_trainer()
    copt = torch.optim.AdamW(cparams.values(), lr=LM_LR, weight_decay=1e-4)
    _, _, closses, _, _ = lm_run(cstep, cparams, init_train_state(
        copt, 2.0 ** 12), batches, key)
    del cparams, copt, cstep
    torch.cuda.empty_cache()
    print(f"train_lm_control: losses with the 8-bit AdamW "
          f"{', '.join(f'{v:.4f}' for v in losses)} (elements with v = 0 "
          f"and m != 0 {[p['v_underflow'] for p in per_step]}, e4m3 NaN "
          f"codes in v {[p['v_nan'] for p in per_step]}); with "
          f"torch.optim.AdamW (f32 moments) "
          f"{', '.join(f'{v:.4f}' for v in closses)}")
    record["train_lm_control"] = {"opt8_losses": losses,
                                  "opt8_per_step": per_step,
                                  "adamw_f32_losses": closses}


def lm_hw_patched(batch, key):
    """hybrid with hw patching at LM_HW_LAYERS layers and the batch given
    (LM_HW_BATCH sequences on the main path): the attention
    BatchMatmuls go through the engine one slice at a time.  The e4m3
    forward takes K2's hw route outside the kernel (both operands exact in
    bf16, as the JAX package's ``_hw_xla_ok``), the backward two uncast K2
    GEMMs a slice; one step counted by variant, every K2 launch of one
    step's gradients held to k2_reference, and the step's loss against the
    same step with K2's plain version (f32, and f64 sums)."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    from fp8tpu_torch.numerics import prng
    from fp8tpu_torch.training import step_grads

    problems = []
    model, emu, params, opt, step, state = lm_trainer(
        n_layers=LM_HW_LAYERS, algo="hybrid", emb=None, hw=True)
    qmatmul.reset_launches()
    with _Counting(qmatmul, "plain", forbid=True):
        k0 = dict(qmatmul.k2_launches)
        t = time.perf_counter()
        params, state, loss = step(params, state, batch, prng.fold_in(key, 0))
        torch.cuda.synchronize()
        hw_ms = 1000 * (time.perf_counter() - t)
    counts = {v: qmatmul.k2_launches[v] - k0[v] for v in k0}
    slices = 2 * LM_HW_LAYERS * batch.shape[0] * LM["n_heads"]
    print(f"train_lm hw: hybrid with hw patching, {LM_HW_LAYERS} layers: "
          f"{hw_ms:.1f} ms for one step (with the first launches); K2 "
          f"launches {counts} ({slices} BatchMatmul slices); loss "
          f"{float(loss):.5f}")
    if counts["uncast"] != 2 * slices or counts["bitexact"] or counts["hw"]:
        problems.append(f"hw-patched step: K2 launches {counts}, expected "
                        f"{2 * slices} uncast")
    launch, checked, losses = qmatmul._launch, [], {}

    def checking(*args, impl="bitexact", unsplit=False):
        out = launch(*args, impl=impl, unsplit=unsplit)
        checked.append(k2_launch_error(out, args, impl))
        return out

    gkey = prng.fold_in(key, 100)
    for name, fn in (("kernel", checking), ("plain", qmatmul.plain),
                     ("plain_f64", k2_plain_f64)):
        qmatmul._launch = fn
        try:
            losses[name] = float(step_grads(emu, lm_loss(model), params,
                                            batch, gkey, 2.0 ** 12)[0])
        finally:
            qmatmul._launch = launch
    spread = abs(losses["plain"] - losses["plain_f64"])
    gap = abs(losses["kernel"] - losses["plain"])
    limit = max(LM_LOSS_RTOL * abs(losses["plain"]), 3 * spread)
    print(f"train_lm hw: one step's {len(checked)} K2 launches against the "
          f"exact product of their own operands: worst |err| / tolerance "
          f"{max(checked, default=0.0):.3e} (at most 1); loss kernels {losses['kernel']:.7f}"
          f", plain {losses['plain']:.7f}, plain f64 sums "
          f"{losses['plain_f64']:.7f}: |kernels - plain| {gap:.3e} (at most "
          f"{limit:.3e}: 1e-5 relative, or 3x the f32 / f64 spread)")
    if len(checked) != 2 * slices or max(checked, default=0.0) > 1.0:
        problems.append(f"hw-patched step: {len(checked)} K2 launches "
                        f"checked, worst {max(checked, default=0.0)} of the bound")
    if gap > limit:
        problems.append(f"hw-patched step loss {losses}")
    return {"ms_first_step": hw_ms, "k2_launches": counts,
            "launch_err_over_bound_max": max(checked, default=0.0),
            "losses": losses,
            "problems": problems}


# -- phase serve -----------------------------------------------------------------

SERVE_SLOTS = 8                # slots of the served engine
SERVE_SEQ = 512                # its ring size
SERVE_NEW = 32                 # new tokens per request
BENCH_BATCH, BENCH_CACHE, BENCH_WARM_POS, BENCH_STEPS = 64, 512, 444, 32
PREFILL_TOKENS = 256           # the timed paged prefill: 8 prompts of 256
PREFILL_ROWS = SERVE_SLOTS * PREFILL_TOKENS   # rows of each linear of it
# Kernel-vs-plain logits over 4 decode steps, relative to max|logit|: the
# two differ in f32 summation order only, which moves single bf16 steps
# (2^-7 relative) of the activations; 7 linears in each of 16 layers carry
# them to the logits of a random-weight model (first measured: 3.0e-2).
# The ring payloads written on the way must agree on 99% of their bytes.
SERVE_LOGIT_TOL = 5e-2
SERVE_RING_EQUAL = 0.99
STATE = {}                     # parameters shared by the serve and time phases


def serve_config():
    """The full-width decoder of the serving path: 16 layers, d_model 4096,
    32 heads / 8 KV heads, d_ff 11008, vocabulary 32768 (about 2.8 GB of
    e4m3 weights); nothing is cut."""
    from fp8tpu_torch.models import DecoderConfig
    return DecoderConfig(vocab_size=32768, d_model=4096, n_layers=16,
                         n_heads=32, n_kv_heads=8, d_ff=11008,
                         max_seq_len=1024)


class _Counting:
    """Count calls of ``module.name`` (and the decode steps they carry)
    while the context is open; optionally forbid them."""

    def __init__(self, module, name, steps_arg=None, forbid=False):
        self.module, self.name = module, name
        self.steps_arg, self.forbid = steps_arg, forbid
        self.calls = self.steps = 0

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def shim(*a, **kw):
            if self.forbid:
                raise PhaseError(f"{self.name} was called on the card's "
                                 "main path")
            self.calls += 1
            if self.steps_arg is not None:
                self.steps += a[self.steps_arg]
            return self.orig(*a, **kw)

        setattr(self.module, self.name, shim)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def serve_requests(seed: int, n: int, vocab: int):
    import numpy as np
    from fp8tpu_torch.serve import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(
        1, vocab, int(rng.integers(16, 49))).tolist(),
        max_new_tokens=SERVE_NEW) for i in range(n)]


def run_server(params, scfg, n_requests: int, chunk_size: int = 16):
    """Answer ``n_requests`` through an EngineServer; returns ({uid:
    tokens}, seconds, per-request meta)."""
    from fp8tpu_torch.serve import EngineServer, ServingEngine
    eng = ServingEngine(params, scfg, n_slots=SERVE_SLOTS, max_seq=SERVE_SEQ,
                        chunk_size=chunk_size)
    srv = EngineServer(eng).start()
    t0 = time.perf_counter()
    try:
        futs = {r.uid: srv.submit(r) for r in serve_requests(
            7, n_requests, scfg.model.vocab_size)}
        out = {uid: f.result(timeout=600) for uid, f in futs.items()}
    finally:
        srv.stop()
    seconds = time.perf_counter() - t0
    meta = {uid: srv.pop_info(uid).get("meta", {}) for uid in out}
    return out, seconds, meta


def phase_serve(record):
    import dataclasses
    import torch
    from fp8tpu_torch.kernels import inplace, int4_matmul, qmatmul
    from fp8tpu_torch.serve import (RingKVCache, ServeConfig, decode_step,
                                    decode_steps, prefill_batch,
                                    random_serve_params)
    from fp8tpu_torch.serve import engine as engine_mod

    cfg = serve_config()
    L = cfg.n_layers
    scfg = ServeConfig(model=cfg, weight_fmt="e4m3", kv_fmt="int8")
    t0 = time.perf_counter()
    params = STATE["e4m3"] = random_serve_params(cfg, "e4m3", seed=0)
    torch.cuda.synchronize()
    weight_bytes = sum(v.numel() * v.element_size() for v in params.values())
    print(f"serve: random e4m3 artifact, {weight_bytes / 1e9:.3f} GB, made "
          f"in {time.perf_counter() - t0:.1f} s")
    result = {"weight_bytes": weight_bytes}

    # (a) the served main path: 16 requests behind an EngineServer, twice.
    for m in (qmatmul, int4_matmul, inplace):
        m.reset_launches()
    with _Counting(engine_mod, "decode_chunk", steps_arg=6) as dc, \
            _Counting(engine_mod, "prefill_batch") as pb, \
            _Counting(qmatmul, "dequant_matmul_plain", forbid=True), \
            _Counting(inplace, "ring_store_plain", forbid=True), \
            _Counting(inplace, "dyn_store_plain", forbid=True):
        out, seconds, meta = run_server(params, scfg, 16)
    # K3's launches by route: the streaming loop's decode form (decode steps
    # and prompts of at most 64 tokens a batch) and its prefill route
    launches = {"dequant_matmul": qmatmul.dequant_routes["stream"],
                "dequant_matmul_prefill": qmatmul.dequant_routes["prefill"],
                "dyn_store": inplace.launches,
                "ring_store": inplace.routes["ring_store"]}
    general = qmatmul.dequant_routes["general"]
    k3_per_step = (qmatmul.dequant_launches - 7 * L * pb.calls) / dc.steps
    k6_per_step = launches["ring_store"] / dc.steps
    again, seconds2, _ = run_server(params, scfg, 16)
    n_tok = sum(len(v) for v in out.values())
    ttft = sorted(m_["ttft_s"] for m_ in meta.values())
    print(f"serve (a): 16 requests x {SERVE_NEW} tokens through EngineServer "
          f"({SERVE_SLOTS} slots, ring {SERVE_SEQ}, chunks of 16): "
          f"{n_tok} tokens in {seconds:.2f} s ({n_tok / seconds:.1f} "
          f"tokens/s; second run {seconds2:.2f} s), median time to first "
          f"token {ttft[len(ttft) // 2]:.3f} s")
    print(f"serve (a): {dc.steps} decode steps in {dc.calls} chunks, "
          f"{pb.calls} prefill calls; launches {launches}: K3 "
          f"{k3_per_step:.1f} and K6 {k6_per_step:.1f} per decode step, "
          f"{7 * L} K3 per prefill; no plain version called")
    problems = []
    if any(len(v) != SERVE_NEW for v in out.values()) or len(out) != 16:
        problems.append("a request did not finish with its budget")
    if not all(0 <= t < cfg.vocab_size for v in out.values() for t in v):
        problems.append("a token is outside the vocabulary")
    if again != out:
        problems.append("a second run gave other tokens")
    if (k3_per_step != 7 * L or k6_per_step != 1
            or launches["dyn_store"] != launches["ring_store"]):
        problems.append(f"K3 / K6 launches per decode step {k3_per_step} / "
                        f"{k6_per_step}, expected {7 * L} / 1 (ring_store), "
                        f"K6 launches by route {inplace.routes}")
    if launches["dequant_matmul_prefill"] == 0 or general:
        problems.append(f"K3's prefill route launched "
                        f"{launches['dequant_matmul_prefill']} times and the "
                        f"general kernel {general} times on the served path")
    result["a"] = {"tokens": n_tok, "seconds": seconds, "seconds_2": seconds2,
                   "decode_steps": dc.steps, "chunks": dc.calls,
                   "prefills": pb.calls, "launches": launches,
                   "ttft_s": ttft}

    # (b) 4 decode steps from one engine state: kernels against the plain
    # versions on the card.
    def fresh_state():
        gen = torch.Generator(device="cuda").manual_seed(11)
        ring = RingKVCache.create(L, SERVE_SLOTS, SERVE_SEQ, cfg.n_kv_heads,
                                  cfg.head_dim, "int8")
        prompts = torch.randint(1, cfg.vocab_size, (SERVE_SLOTS, 32),
                                device="cuda", generator=gen,
                                dtype=torch.int32)
        lengths = torch.randint(8, 33, (SERVE_SLOTS,), device="cuda",
                                generator=gen, dtype=torch.int32)
        slots = torch.arange(SERVE_SLOTS, device="cuda", dtype=torch.int32)
        zeros = torch.zeros(SERVE_SLOTS, device="cuda")
        first, ring, toks, pos = prefill_batch(
            params, ring, prompts, slots, lengths, None, zeros, None, None,
            torch.zeros(SERVE_SLOTS, device="cuda", dtype=torch.int32),
            torch.zeros(SERVE_SLOTS, device="cuda", dtype=torch.int32), scfg)
        return ring, toks, pos

    ring_k, toks, pos = fresh_state()
    ring_p = RingKVCache(ring_k.kv8.clone(), ring_k.sc.clone(),
                         ring_k.head.clone())
    worst = 0.0
    for step in range(4):
        lk, ring_k = decode_step(params, ring_k, toks, pos, scfg)
        orig = (qmatmul.dequant_matmul, inplace.ring_store)
        qmatmul.dequant_matmul = qmatmul.dequant_matmul_plain
        inplace.ring_store = inplace.ring_store_plain
        try:
            lp, ring_p = decode_step(params, ring_p, toks, pos, scfg)
        finally:
            qmatmul.dequant_matmul, inplace.ring_store = orig
        err = float((lk - lp).abs().max() / lp.abs().max())
        worst = max(worst, err)
        if not bool(torch.isfinite(lk).all()):
            problems.append(f"step {step}: logits not finite")
        toks, pos = lk.argmax(-1).to(torch.int32), pos + 1
    same_bytes = float((ring_k.kv8 == ring_p.kv8).float().mean())
    print(f"serve (b): 4 decode steps, kernels vs plain versions on the "
          f"card: max|logit diff| / max|logit| {worst:.3e} (tolerance "
          f"{SERVE_LOGIT_TOL}), ring payload bytes equal {same_bytes:.4f} "
          f"(at least {SERVE_RING_EQUAL})")
    if worst > SERVE_LOGIT_TOL:
        problems.append(f"kernel and plain logits differ by {worst}")
    if same_bytes < SERVE_RING_EQUAL:
        problems.append(f"kernel and plain ring payloads agree on only "
                        f"{same_bytes} of their bytes")
    if tuple(lk.shape) != (SERVE_SLOTS, cfg.vocab_size):
        problems.append(f"logits of shape {tuple(lk.shape)}")
    result["b"] = {"max_rel_logit_diff": worst, "ring_bytes_equal": same_bytes}
    del ring_k, ring_p

    # (c) the same server at 4 layers with int4 weights: K5 on a real path.
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    scfg4 = ServeConfig(model=cfg4, weight_fmt="int4", kv_fmt="int8")
    params4 = STATE["int4"] = random_serve_params(cfg4, "int4", seed=1)
    int4_matmul.reset_launches()
    with _Counting(engine_mod, "decode_chunk", steps_arg=6) as dc4, \
            _Counting(engine_mod, "prefill_batch") as pb4, \
            _Counting(int4_matmul, "int4_matmul_plain", forbid=True):
        out4, sec4, _ = run_server(params4, scfg4, 8)
    launches["int4_matmul"] = int4_matmul.routes["stream"]
    launches["int4_matmul_prefill"] = int4_matmul.routes["prefill"]
    k5_per_step = (int4_matmul.launches - 28 * pb4.calls) / dc4.steps
    again4, _, _ = run_server(params4, scfg4, 8)
    print(f"serve (c): int4 weights (group 128), 4 layers: 8 requests x "
          f"{SERVE_NEW} tokens in {sec4:.2f} s; {int4_matmul.launches} K5 "
          f"launches, {k5_per_step:.1f} per decode step")
    if any(len(v) != SERVE_NEW for v in out4.values()) or again4 != out4:
        problems.append("int4 serving: budgets or repeatability")
    if k5_per_step != 28:
        problems.append(f"{k5_per_step} K5 launches per step, expected 28")
    if int4_matmul.routes["prefill"] == 0 or int4_matmul.routes["general"]:
        problems.append(f"K5 launches by route {int4_matmul.routes}: the "
                        "prefill route never ran, or the general kernel did")
    result["c"] = {"seconds": sec4, "launches": int4_matmul.launches,
                   "decode_steps": dc4.steps}

    # (d) timed decode: batch 64 at near-full context, chunks of 32 greedy
    # steps, e4m3 weights + int8 KV against the bf16 / bf16 twin.
    def bench(fmt, kv_fmt, prm):
        bcfg = ServeConfig(model=cfg, weight_fmt=fmt, kv_fmt=kv_fmt)
        ring = RingKVCache.create(L, BENCH_BATCH, BENCH_CACHE, cfg.n_kv_heads,
                                  cfg.head_dim, kv_fmt)
        ring.head = torch.tensor(BENCH_WARM_POS, device="cuda",
                                 dtype=torch.int32)
        toks = torch.ones(BENCH_BATCH, device="cuda", dtype=torch.int32)
        pos = torch.full((BENCH_BATCH,), BENCH_WARM_POS, device="cuda",
                         dtype=torch.int32)
        temp = torch.zeros(BENCH_BATCH, device="cuda")

        def chunk(n):
            nonlocal ring
            out_, ring = decode_steps(prm, ring, toks, pos, None, temp, n,
                                      bcfg, greedy_only=True)
            return out_

        chunk(2)
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t = time.perf_counter()
            last = chunk(BENCH_STEPS)
            int(last.sum())                      # one readback closes it
            times.append(time.perf_counter() - t)
        best = min(times)
        prof = profile_decode_step(lambda: chunk(1), best / BENCH_STEPS * 1e3)
        kv = ring.kv8[:, 0, 0]
        upcast = cuda_ms(lambda: kv.to(torch.bfloat16)) * 2 * L
        return {"tokens_per_s": BENCH_BATCH * BENCH_STEPS / best,
                "step_ms": best / BENCH_STEPS * 1e3,
                "chunk_s": times, "profile": prof,
                "kv_upcast_ms_per_step": upcast,
                "ring_bytes": ring.kv8.numel() * ring.kv8.element_size()
                + ring.sc.numel() * 4}

    fp8 = bench("e4m3", "int8", params)
    bf16_params = random_serve_params(cfg, "bf16", seed=0)
    twin = bench("bf16", "bf16", bf16_params)
    del bf16_params
    torch.cuda.empty_cache()
    for name, r in (("e4m3 weights + int8 KV", fp8),
                    ("bf16 weights + bf16 KV (torch.matmul linears)", twin)):
        prof = r["profile"]
        print(f"serve (d): {name}: {r['tokens_per_s']:.1f} tokens/s, "
              f"{r['step_ms']:.3f} ms/step (batch {BENCH_BATCH}, ring "
              f"{BENCH_CACHE}, position {BENCH_WARM_POS}, chunks of "
              f"{BENCH_STEPS}); one step: {prof['device_ms']:.3f} ms of "
              f"kernels in {prof['launches']} launches, device-busy share "
              f"{prof['busy_share']:.3f}; KV upcast copies "
              f"{r['kv_upcast_ms_per_step']:.3f} ms/step; ring "
              f"{r['ring_bytes'] / 1e6:.1f} MB")
        for group, (ms, n) in prof["groups"].items():
            print(f"    {ms:8.3f} ms {n:5d}x  {group}")
    print(f"serve (d): fp8 / bf16-twin tokens/s ratio "
          f"{fp8['tokens_per_s'] / twin['tokens_per_s']:.3f}")
    result["d"] = {"fp8": fp8, "bf16": twin}
    record["serve"] = result
    if problems:
        raise PhaseError("; ".join(problems))
    return launches


# torch.profiler can lose the device records of the first launches of its
# window (20-odd in one 8 x 256 prefill profile: the first K3 among them;
# phase_profile_probe): a profile opens with a lead-in of spin kernels,
# waits, then runs the work; the lead-in's records are left out.
PROFILE_LEAD_LAUNCHES = 64
PROFILE_LEAD_S = 0.05
LEAD_KERNEL = "spin_kernel"    # torch.cuda._sleep's kernel


def kernel_kind(name: str) -> str:
    """The group of a device event's name in the profiles' breakdowns."""
    low = name.lower()
    if "P1Fp8" in name:               # ws::stream_kernel<P1Fp8<...>, ...>
        return "P1 fp8 x fp8 GEMM (hand-written)"
    if "quantize_rows_kernel" in name:
        return "P2 row quantizer (hand-written)"
    if "w_gemm" in name or "ws::stream_kernel" in name:
        return "K3/K5 weight GEMM (hand-written)"
    if "ring_store_kernel" in name:
        return "K6 ring store (hand-written)"
    if "paged_attention_kernel" in name:
        return "K4 paged attention (hand-written)"
    if any(w in low for w in ("gemm", "cutlass", "xmma", "gemv", "cublas",
                              "nvjet")):
        return "library matmuls (attention, LM head, bf16 linears)"
    if "copy" in low or "memcpy" in low:
        return "copies and casts (KV upcast to bf16, slabs, dtype casts)"
    if "reduce" in low or "softmax" in low or "argmax" in low:
        return "reductions (rms mean, amax, sums, argmax)"
    return "elementwise and other"


def profile_lead_in():
    """The opening of a profile window: PROFILE_LEAD_LAUNCHES short spin
    kernels (LEAD_KERNEL), the device drained, a PROFILE_LEAD_S wait."""
    import torch
    for _ in range(PROFILE_LEAD_LAUNCHES):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(PROFILE_LEAD_S)


def open_profile(step, lead: bool = True):
    """``step()`` once under torch.profiler (CPU and CUDA activities), after
    one call outside it; with ``lead``, the window opens with
    ``profile_lead_in``.  Returns the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        if lead:
            profile_lead_in()
        step()
        torch.cuda.synchronize()
    return p


def profile_decode_step(step, step_ms: float, steps: int = 1):
    """Device time of one decode step by kind of kernel (torch.profiler);
    fails if the profiler saw no device time.  ``step`` runs ``steps``
    decode steps (one chunk, where work done once per chunk must be shared
    out); times and launch counts are per step."""
    import torch
    p = open_profile(step)
    groups, names = {}, {}
    for e in p.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                LEAD_KERNEL in e.name:
            continue
        ms = (getattr(e, "device_time", None) or e.cuda_time) / 1000.0 / steps
        kind = kernel_kind(e.name)
        t, n = groups.get(kind, (0.0, 0))
        groups[kind] = (t + ms, n + 1)
        t, n = names.get(e.name, (0.0, 0))
        names[e.name] = (t + ms, n + 1)
    if steps > 1:
        groups = {k: (t, round(n / steps)) for k, (t, n) in groups.items()}
        names = {k: (t, round(n / steps)) for k, (t, n) in names.items()}
    busy = sum(t for t, _ in groups.values())
    if not busy > 0:
        raise PhaseError("torch.profiler recorded no device time")
    top = sorted(((t, n, k) for k, (t, n) in names.items()), reverse=True)
    return {"device_ms": busy, "step_ms": step_ms,
            "busy_share": busy / step_ms,
            "launches": sum(n for _, n in groups.values()),
            "groups": dict(sorted(groups.items(), key=lambda kv: -kv[1][0])),
            "top_kernels": [{"name": k[:120], "ms": t, "count": n}
                            for t, n, k in top[:12]]}


# -- phase serve_paged ---------------------------------------------------------

PAGE = 64                      # tokens per page of the served pool
PREFIX_LEN = 128               # the shared system prefix: two full pages
LONG_PROMPT, LONG_NEW, LONG_SEQ = 700, 200, 1024
PROFILE_STEPS = 8              # steps of the chunk that (d) profiles


def paged_requests(seed: int, n: int, vocab: int):
    """Prompts that share a 128-token system prefix followed by 16-48
    tokens of their own."""
    import numpy as np
    from fp8tpu_torch.serve import Request
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, PREFIX_LEN).tolist()
    return [Request(uid=i, prompt=prefix + rng.integers(
        1, vocab, int(rng.integers(16, 49))).tolist(),
        max_new_tokens=SERVE_NEW) for i in range(n)]


def run_paged_server(params, scfg, requests, n_slots=SERVE_SLOTS,
                     max_seq=SERVE_SEQ, chunk_size=16, prefix_cache=True):
    """Answer ``requests`` through an EngineServer over the paged engine;
    returns ({uid: tokens}, seconds, the engine)."""
    from fp8tpu_torch.serve import EngineServer, ServingEngine
    eng = ServingEngine(params, scfg, n_slots=n_slots, max_seq=max_seq,
                        chunk_size=chunk_size, use_paged=True, page_size=PAGE,
                        prefix_cache=prefix_cache)
    srv = EngineServer(eng).start()
    t0 = time.perf_counter()
    try:
        futs = {r.uid: srv.submit(r) for r in requests}
        out = {uid: f.result(timeout=900) for uid, f in futs.items()}
    finally:
        srv.stop()
    return out, time.perf_counter() - t0, eng


def phase_serve_paged(record):
    import dataclasses
    import torch
    from fp8tpu_torch.kernels import paged_attention as k4
    from fp8tpu_torch.kernels import qmatmul
    from fp8tpu_torch.serve import (PagedKVCache, ServeConfig,
                                    decode_step_paged, decode_steps_paged,
                                    full_logits, prefill_batch_paged,
                                    random_serve_params)
    from fp8tpu_torch.serve import engine as engine_mod

    cfg = serve_config()
    L, KV, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    scfg = ServeConfig(model=cfg, weight_fmt="e4m3", kv_fmt="int8",
                       paged_decode_impl="kernel")
    params = STATE.get("e4m3")
    if params is None:
        params = STATE["e4m3"] = random_serve_params(cfg, "e4m3", seed=0)
    result, problems = {}, []

    # (a) the served main path: 16 requests with a shared prefix, twice.
    reqs = paged_requests(9, 16, cfg.vocab_size)
    qmatmul.reset_launches()
    k4.reset_launches()
    with _Counting(engine_mod, "decode_chunk_paged", steps_arg=6) as dc, \
            _Counting(engine_mod, "prefill_batch_paged") as pb, \
            _Counting(qmatmul, "dequant_matmul_plain", forbid=True), \
            _Counting(k4, "paged_decode_attention_plain", forbid=True):
        out, seconds, eng = run_paged_server(params, scfg, reqs)
    launches = {"paged_decode_attention": k4.launches,
                "dequant_matmul": qmatmul.dequant_routes["stream"],
                "dequant_matmul_prefill": qmatmul.dequant_routes["prefill"]}
    general = qmatmul.dequant_routes["general"]
    k4_per_step = k4.launches / dc.steps
    k3_per_step = (qmatmul.dequant_launches - 7 * L * pb.calls) / dc.steps
    again, seconds2, _ = run_paged_server(
        params, scfg, paged_requests(9, 16, cfg.vocab_size))
    n_tok = sum(len(v) for v in out.values())
    stats = eng.page_stats
    no_cache = sum(-(-(len(r.prompt) + r.max_new_tokens + 1) // PAGE)
                   for r in reqs)
    evictable = sum(1 for p in eng._prefix_index.values()
                    if eng._page_ref[p] == 0)
    print(f"serve_paged (a): 16 requests x {SERVE_NEW} tokens, prompts of a "
          f"shared {PREFIX_LEN}-token prefix + 16-48 tokens, through "
          f"EngineServer (paged pool of {eng.cache.n_pages} pages of {PAGE}, "
          f"{SERVE_SLOTS} slots, prefix cache, chunks of 16): {n_tok} tokens "
          f"in {seconds:.2f} s ({n_tok / seconds:.1f} tokens/s; second run "
          f"{seconds2:.2f} s)")
    print(f"serve_paged (a): {dc.steps} decode steps in {dc.calls} chunks, "
          f"{pb.calls} prefill calls; launches {launches}: K4 "
          f"{k4_per_step:.1f} and K3 {k3_per_step:.1f} per decode step; no "
          f"plain version called; pages allocated {stats['allocated']} "
          f"(without the cache: {no_cache}), shared mappings "
          f"{stats['shared']}, most holders of one page {stats['max_ref']}; "
          f"at the end {len(eng.free_pages)} free + {evictable} cached of "
          f"{eng.cache.n_pages}")
    if any(len(v) != SERVE_NEW for v in out.values()) or len(out) != 16:
        problems.append("a request did not finish with its budget")
    if not all(0 <= t < cfg.vocab_size for v in out.values() for t in v):
        problems.append("a token is outside the vocabulary")
    if again != out:
        problems.append("a second run gave other tokens")
    if k4_per_step != L or k3_per_step != 7 * L:
        problems.append(f"K4 / K3 launches per decode step {k4_per_step} / "
                        f"{k3_per_step}, expected {L} / {7 * L}")
    if launches["dequant_matmul_prefill"] != 7 * L * pb.calls or general:
        problems.append(f"K3 launches by route {launches} (general: "
                        f"{general}): every linear of the {pb.calls} "
                        "prefills (prompts of 144-176 tokens) should take "
                        "the prefill route")
    if stats["max_ref"] < 2 or stats["shared"] < 2:
        problems.append("the prefix pages were not shared between slots")
    if stats["allocated"] >= no_cache:
        problems.append("the prefix cache saved no page")
    if len(eng.free_pages) + evictable != eng.cache.n_pages \
            or int(eng._page_ref.sum()) != 0:
        problems.append("pages were not reclaimed at the end")
    result["a"] = {"tokens": n_tok, "seconds": seconds, "seconds_2": seconds2,
                   "decode_steps": dc.steps, "chunks": dc.calls,
                   "prefills": pb.calls, "launches": launches,
                   "page_stats": stats, "pages_without_cache": no_cache}
    del eng

    # (b) 4 decode steps from one pool state: "kernel" mode against the same
    # steps with the plain versions, and against "ringview".
    def fresh_pool():
        gen = torch.Generator(device="cuda").manual_seed(12)
        paged = PagedKVCache.create(SERVE_SLOTS * 8, PAGE, L, SERVE_SLOTS, 8,
                                    KV, D, "int8")
        table = torch.randperm(SERVE_SLOTS * 8, device="cuda", generator=gen
                               ).to(torch.int32).reshape(SERVE_SLOTS, 8)
        paged.page_table = table
        prompts = torch.randint(1, cfg.vocab_size, (SERVE_SLOTS, 256),
                                device="cuda", generator=gen,
                                dtype=torch.int32)
        lengths = torch.randint(70, 257, (SERVE_SLOTS,), device="cuda",
                                generator=gen, dtype=torch.int32)
        slots = torch.arange(SERVE_SLOTS, device="cuda", dtype=torch.int32)
        zeros = torch.zeros(SERVE_SLOTS, device="cuda")
        zi = torch.zeros(SERVE_SLOTS, device="cuda", dtype=torch.int32)
        _, paged, toks, pos = prefill_batch_paged(
            params, paged, prompts, slots, lengths, None, zeros, None, None,
            zi, zi.clone(), scfg)
        return paged, toks, pos

    def clone(paged):
        return PagedKVCache(pool=paged.pool.clone(), sc=paged.sc.clone(),
                            page_table=paged.page_table.clone(), kv_heads=KV)

    pool_k, toks, pos = fresh_pool()
    pool_p, pool_r = clone(pool_k), clone(pool_k)
    rcfg = dataclasses.replace(scfg, paged_decode_impl="ringview")
    worst_p = worst_r = 0.0
    for step in range(4):
        lk, pool_k = decode_step_paged(params, pool_k, toks, pos, scfg)
        orig = (qmatmul.dequant_matmul, k4.paged_decode_attention)
        qmatmul.dequant_matmul = qmatmul.dequant_matmul_plain
        k4.paged_decode_attention = k4.paged_decode_attention_plain
        try:
            lp, pool_p = decode_step_paged(params, pool_p, toks, pos, scfg)
        finally:
            qmatmul.dequant_matmul, k4.paged_decode_attention = orig
        lr, pool_r = decode_step_paged(params, pool_r, toks, pos, rcfg)
        worst_p = max(worst_p, float((lk - lp).abs().max() / lp.abs().max()))
        worst_r = max(worst_r, float((lk - lr).abs().max() / lr.abs().max()))
        if not bool(torch.isfinite(lk).all()):
            problems.append(f"paged step {step}: logits not finite")
        toks, pos = lk.argmax(-1).to(torch.int32), pos + 1
    same_p = float((pool_k.pool == pool_p.pool).float().mean())
    same_r = float((pool_k.pool == pool_r.pool).float().mean())
    print(f"serve_paged (b): 4 decode steps in \"kernel\" mode vs the plain "
          f"versions on the card: max|logit diff| / max|logit| {worst_p:.3e}, "
          f"pool payload bytes equal {same_p:.4f}; vs \"ringview\": "
          f"{worst_r:.3e}, {same_r:.4f} (tolerance {SERVE_LOGIT_TOL}, at "
          f"least {SERVE_RING_EQUAL})")
    if max(worst_p, worst_r) > SERVE_LOGIT_TOL:
        problems.append(f"paged kernel logits differ by {worst_p} (plain) / "
                        f"{worst_r} (ringview)")
    if min(same_p, same_r) < SERVE_RING_EQUAL:
        problems.append(f"pool payloads agree on only {same_p} / {same_r}")
    result["b"] = {"vs_plain": worst_p, "vs_ringview": worst_r,
                   "pool_bytes_equal_plain": same_p,
                   "pool_bytes_equal_ringview": same_r}
    del pool_k, pool_p, pool_r

    # (c) a context beyond the ring of the serve phase: one request of 700
    # prompt tokens and 200 new ones; then its tokens against a
    # teacher-forced dense forward over the same 899 tokens.
    import numpy as np
    from fp8tpu_torch.serve import Request
    rng = np.random.default_rng(21)
    long_req = Request(uid=0, prompt=rng.integers(
        1, cfg.vocab_size, LONG_PROMPT).tolist(), max_new_tokens=LONG_NEW)
    k4.reset_launches()
    out_l, sec_l, eng_l = run_paged_server(
        params, scfg, [long_req], n_slots=2, max_seq=LONG_SEQ, chunk_size=32,
        prefix_cache=False)
    got = out_l[0]
    seq = torch.tensor(long_req.prompt + got[:-1], device="cuda",
                       dtype=torch.int32)
    dense = full_logits(params, seq, scfg)[LONG_PROMPT - 1:].argmax(-1)
    agree = float((dense.cpu() == torch.tensor(got)).float().mean())
    print(f"serve_paged (c): one request, prompt {LONG_PROMPT} + "
          f"{len(got)} new tokens (context {LONG_PROMPT + len(got)} > the "
          f"ring's {SERVE_SEQ}; pool max_seq {LONG_SEQ}) in {sec_l:.2f} s, "
          f"{k4.launches} K4 launches; greedy tokens equal to a "
          f"teacher-forced dense forward's at {agree:.3f} of the positions")
    if len(got) != LONG_NEW:
        problems.append("the long request did not finish with its budget")
    if agree < 0.5:
        problems.append(f"long-context tokens agree with the dense forward "
                        f"at only {agree}")
    if len(eng_l.free_pages) != eng_l.cache.n_pages:
        problems.append("the long request's pages were not reclaimed")
    result["c"] = {"seconds": sec_l, "tokens": len(got),
                   "dense_agreement": agree}
    del eng_l

    # (d) timed decode at batch 64, position 444, chunks of 32: "kernel"
    # and "ringview" in turns on one pool.
    def make_bench(impl):
        bcfg = dataclasses.replace(scfg, paged_decode_impl=impl)
        mp = BENCH_CACHE // PAGE
        paged = PagedKVCache.create(BENCH_BATCH * mp, PAGE, L, BENCH_BATCH,
                                    mp, KV, D, "int8")
        gen = torch.Generator(device="cuda").manual_seed(13)
        paged.page_table = torch.randperm(
            BENCH_BATCH * mp, device="cuda", generator=gen
        ).to(torch.int32).reshape(BENCH_BATCH, mp)
        paged.pool.copy_(torch.randint(-127, 128, paged.pool.shape,
                                       device="cuda", generator=gen,
                                       dtype=torch.int8))
        toks = torch.ones(BENCH_BATCH, device="cuda", dtype=torch.int32)
        pos = torch.full((BENCH_BATCH,), BENCH_WARM_POS, device="cuda",
                         dtype=torch.int32)
        temp = torch.zeros(BENCH_BATCH, device="cuda")

        def chunk(n):
            out_, _ = decode_steps_paged(params, paged, toks, pos, None, temp,
                                         n, bcfg, greedy_only=True)
            return out_
        return chunk

    chunks = {impl: make_bench(impl) for impl in ("kernel", "ringview")}
    times = {impl: [] for impl in chunks}
    for impl in chunks:
        chunks[impl](2)
    torch.cuda.synchronize()
    for impl in ("kernel", "ringview", "ringview", "kernel"):
        t = time.perf_counter()
        int(chunks[impl](BENCH_STEPS).sum())         # one readback closes it
        times[impl].append(time.perf_counter() - t)
    bench = {}
    for impl, fn in chunks.items():
        best = min(times[impl])
        # an 8-step chunk: tracing all 32 steps (60 000 launches) takes a
        # minute, and what a chunk does once (the snapshot gather, the
        # deferred pool write) still shows, shared over 8 steps, not 32
        prof = profile_decode_step(lambda: fn(PROFILE_STEPS),
                                   best / BENCH_STEPS * 1e3, PROFILE_STEPS)
        bench[impl] = {"tokens_per_s": BENCH_BATCH * BENCH_STEPS / best,
                       "step_ms": best / BENCH_STEPS * 1e3,
                       "chunk_s": times[impl], "profile": prof}
        print(f"serve_paged (d): \"{impl}\": "
              f"{bench[impl]['tokens_per_s']:.1f} tokens/s, "
              f"{bench[impl]['step_ms']:.3f} ms/step (batch {BENCH_BATCH}, "
              f"pool of {BENCH_CACHE} tokens a slot, position "
              f"{BENCH_WARM_POS}, chunks of {BENCH_STEPS}); per step of a "
              f"profiled {PROFILE_STEPS}-step chunk: "
              f"{prof['device_ms']:.3f} ms of kernels in "
              f"{prof['launches']} launches, device-busy share "
              f"{prof['busy_share']:.3f}")
        for group, (ms, n) in prof["groups"].items():
            print(f"    {ms:8.3f} ms {n:5d}x  {group}")
    ring = record.get("serve", {}).get("d", {}).get("fp8")
    if ring:
        print(f"serve_paged (d): the ring path in this run (serve (d)): "
              f"{ring['tokens_per_s']:.1f} tokens/s, {ring['step_ms']:.3f} "
              f"ms/step, {ring['profile']['device_ms']:.3f} ms of kernels")
    result["d"] = bench
    record["serve_paged"] = result
    del chunks
    torch.cuda.empty_cache()
    if problems:
        raise PhaseError("; ".join(problems))
    return launches

# -- phase spec ------------------------------------------------------------------

SPEC_K = 4                     # tokens drafted a round
SPEC_RPD = 4                   # rounds a dispatch of the served engine
SPEC_POS = 444                 # context of the verify passes and timed rounds
SPEC_MP = 8                    # pages a slot in those pools (512 tokens)


def draft_serve_config():
    """The draft of the speculation path, at the widths of the JAX
    package's speculation bench (tools/bench_spec.py): 2 layers, d_model
    512, 8 heads / 4 KV heads of 64, d_ff 2048, the target's vocabulary."""
    from fp8tpu_torch.models import DecoderConfig
    return DecoderConfig(vocab_size=32768, d_model=512, n_layers=2,
                         n_heads=8, n_kv_heads=4, d_ff=2048,
                         max_seq_len=1024)


def spec_pool(cfg, batch, gen, positions=SPEC_POS):
    """A paged int8 pool of ``batch`` slots x SPEC_MP pages of 64 behind a
    shuffled page table, random payloads and scales: the cached context of
    ``positions`` tokens a slot."""
    import torch
    from fp8tpu_torch.serve import PagedKVCache
    paged = PagedKVCache.create(batch * SPEC_MP, PAGE, cfg.n_layers, batch,
                                SPEC_MP, cfg.n_kv_heads, cfg.head_dim, "int8")
    paged.page_table = torch.randperm(
        batch * SPEC_MP, device="cuda", generator=gen
    ).to(torch.int32).reshape(batch, SPEC_MP)
    paged.pool.copy_(torch.randint(-127, 128, paged.pool.shape, device="cuda",
                                   generator=gen, dtype=torch.int8))
    paged.sc.uniform_(0.004, 0.02, generator=gen)
    pos = torch.full((batch,), positions, device="cuda", dtype=torch.int32)
    return paged, pos


def clone_pool(paged):
    from fp8tpu_torch.serve import PagedKVCache
    return PagedKVCache(pool=paged.pool.clone(), sc=paged.sc.clone(),
                        page_table=paged.page_table.clone(),
                        kv_heads=paged.kv_heads)


def with_plain_kernels(fn):
    """``fn()`` with K3, K4, K5, K6, P1 and P2 replaced by their plain
    versions."""
    from fp8tpu_torch.kernels import inplace, int4_matmul, qmatmul
    from fp8tpu_torch.kernels import paged_attention as k4
    orig = (qmatmul.dequant_matmul, k4.paged_decode_attention,
            inplace.ring_store, int4_matmul.int4_matmul,
            qmatmul.w8a8_matmul, qmatmul.quantize_rows)
    qmatmul.dequant_matmul = qmatmul.dequant_matmul_plain
    k4.paged_decode_attention = k4.paged_decode_attention_plain
    inplace.ring_store = inplace.ring_store_plain
    int4_matmul.int4_matmul = int4_matmul.int4_matmul_plain
    qmatmul.w8a8_matmul = qmatmul.w8a8_matmul_plain
    qmatmul.quantize_rows = qmatmul.quantize_rows_plain
    try:
        return fn()
    finally:
        (qmatmul.dequant_matmul, k4.paged_decode_attention,
         inplace.ring_store, int4_matmul.int4_matmul,
         qmatmul.w8a8_matmul, qmatmul.quantize_rows) = orig


def with_plain_but_k4(fn):
    """``fn()`` with the plain versions of with_plain_kernels, K4 (the
    paged attention kernel) excepted."""
    from fp8tpu_torch.kernels import paged_attention as k4
    kernel = k4.paged_decode_attention

    def inner():
        k4.paged_decode_attention = kernel
        return fn()
    return with_plain_kernels(inner)


class _CheckedK4:
    """While the context is open, every K4 launch is held against its plain
    version on the same operands within k4_reference's bounds: one dict a
    launch in ``checks``."""

    def __init__(self, checks):
        self.checks = checks

    def __enter__(self):
        from fp8tpu_torch.kernels import paged_attention as k4
        self.k4, self.orig = k4, k4.paged_decode_attention
        orig, checks = self.orig, self.checks

        def checked(q, pool, sc, table, lens, layer, page_size, kv_heads):
            out = orig(q, pool, sc, table, lens, layer, page_size=page_size,
                       kv_heads=kv_heads)
            acc, m, l = out
            acc_p, m_p, l_p = k4.paged_decode_attention_plain(
                q, pool, sc, table, lens, layer, page_size=page_size,
                kv_heads=kv_heads)
            _, _, _, m_tol, l_tol, acc_tol = k4_reference(
                q, pool, sc, table, lens, layer, kv=kv_heads, page=page_size)
            checks.append({
                "shape": tuple(q.shape), "kv_heads": kv_heads,
                "ok": bool(((m - m_p).abs() <= m_tol).all()
                           and ((l - l_p).abs() <= l_tol).all()
                           and ((acc - acc_p).abs() <= acc_tol).all()),
                "err_over_bound": float(((acc - acc_p).abs()
                                         / acc_tol).max())})
            return out

        k4.paged_decode_attention = checked
        return self

    def __exit__(self, *exc):
        self.k4.paged_decode_attention = self.orig


SPEC_LAYER_EQUAL = 0.25        # equal payload bytes in every layer (below)


def layer_distance(a, sa, b, sb):
    """Per layer (dim 2), how far two int8 caches written through other
    summation orders lie apart: ``a`` / ``b`` are payloads (rows, 2, L,
    ..., D) as the caches hold them, ``sa`` / ``sb`` their scales (the
    payload's shape without D).  Returns one dict a layer: the share of
    equal payload bytes, the largest payload difference in int8 steps, and
    the largest difference of the dequantized values over the layer's
    largest |value|.  Layer 0's k / v come from the embedding through one
    K3 launch each, so they differ from the plain version's only where f32
    summation order moves a bf16 rounding; deeper layers carry every
    earlier layer's differences, which move few bytes far (a bf16 step of
    the hidden state) but many by a step.  A row written to the wrong
    place, or k and v swapped, moves the dequantized values by the
    layer's own scale."""
    import torch
    n = a.shape[2]

    def by_layer(t):
        return t.transpose(0, 2).reshape(n, -1)

    pa, pb = by_layer(a), by_layer(b)
    da = by_layer(a.float() * sa.unsqueeze(-1))
    db = by_layer(b.float() * sb.unsqueeze(-1))
    out = []
    for i in range(n):
        steps = (pa[i].to(torch.int16) - pb[i].to(torch.int16)).abs()
        out.append({"equal": float((pa[i] == pb[i]).float().mean()),
                    "steps": int(steps.max()),
                    "deq": float((da[i] - db[i]).abs().max()
                                 / db[i].abs().max())})
    return out


def layer_problems(dist, what, layers=None):
    """The gate on :func:`layer_distance` over its first ``layers`` (all
    by default): layer 0 at least SERVE_RING_EQUAL equal, every other
    layer at least SPEC_LAYER_EQUAL, and each layer's dequantized values
    within the decode limit."""
    bad = [f"layer {i}: {d}" for i, d in enumerate(dist[:layers])
           if d["equal"] < (SERVE_RING_EQUAL if i == 0 else SPEC_LAYER_EQUAL)
           or not d["deq"] <= SERVE_LOGIT_TOL]
    return [f"{what}: {'; '.join(bad)}"] if bad else []


def fmt_layers(dist) -> str:
    """Equal shares, int8 steps and dequantized distances by layer."""
    return ("equal [" + ", ".join(f"{d['equal']:.3f}" for d in dist)
            + "], most int8 steps [" + ", ".join(str(d["steps"]) for d in dist)
            + "], dequantized [" + ", ".join(f"{d['deq']:.2e}" for d in dist)
            + "]")


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def near_tie(logits, tol=SERVE_LOGIT_TOL) -> bool:
    """The margin rule: the top-2 margin lies inside the logit tolerance."""
    top2 = logits.float().topk(2).values
    return float(top2[0] - top2[1]) <= 2 * tol * float(logits.abs().max())


def margin_agree(out, ref, prompts, params, scfg):
    """Every token of ``out`` held to the margin rule by a teacher-forced
    dense forward over its own list: each emitted token is the argmax of
    its step's logits or lies within the band 2 SERVE_LOGIT_TOL max|logit|
    of the top, at every step, past the first one where ``out`` parts from
    ``ref`` too.  Returns ({uid: first index where the lists part, or
    None}, the share of steps whose top-2 margin lies inside the band, and
    {uid: steps whose token lies outside the band} with every list of the
    wrong length among them, and the mean number of tokens inside the band
    a step: the chance that a wrong token passes is about that over the
    vocabulary)."""
    import torch
    from fp8tpu_torch.serve import full_logits
    parts, bad, ties, steps, inside = {}, {}, 0, 0, 0
    for uid, want in ref.items():
        got = out.get(uid, [])
        parts[uid] = next((i for i in range(min(len(got), len(want)))
                           if got[i] != want[i]),
                          None if len(got) == len(want) else
                          min(len(got), len(want)))
        if len(got) != len(want):
            bad[uid] = f"{len(got)} tokens, not {len(want)}"
            continue
        n = len(prompts[uid])
        seq = torch.tensor(prompts[uid] + got, device="cuda",
                           dtype=torch.int32)
        lg = full_logits(params, seq, scfg)[n - 1:-1].float()
        top2 = lg.topk(2, dim=-1).values
        band = 2 * SERVE_LOGIT_TOL * lg.abs().amax(-1)
        picked = lg.gather(1, seq[n:, None].long())[:, 0]
        off = torch.nonzero(top2[:, 0] - picked > band).flatten().tolist()
        if off:
            bad[uid] = off
        ties += int((top2[:, 0] - top2[:, 1] <= band).sum())
        inside += int((lg >= (top2[:, 0] - band)[:, None]).sum())
        steps += len(got)
    return parts, ties / max(steps, 1), bad, inside / max(steps, 1)


def phase_spec(record):
    """Draft-and-verify speculation at full width: the verify passes'
    kernels against their plain versions, the draft's K4 launches at D =
    64, the served engine with an independent draft and a self-draft, the
    scored admission, and one timed dispatch at 8 and 64 slots."""
    import dataclasses
    import numpy as np
    import torch
    from fp8tpu_torch.kernels import inplace, qmatmul
    from fp8tpu_torch.kernels import paged_attention as k4
    from fp8tpu_torch.serve import (EngineServer, RingKVCache, ServeConfig,
                                    ServingEngine, decode_step,
                                    decode_steps_paged, full_logits,
                                    prefill_batch_paged, random_serve_params)
    from fp8tpu_torch.serve import speculative as spec

    cfg, dcfg = serve_config(), draft_serve_config()
    L, KV, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    scfg = ServeConfig(model=cfg, weight_fmt="e4m3", kv_fmt="int8",
                       paged_decode_impl="kernel")
    dscfg = ServeConfig(model=dcfg, weight_fmt="e4m3", kv_fmt="int8",
                        paged_decode_impl="kernel")
    params = STATE.get("e4m3")
    if params is None:
        params = STATE["e4m3"] = random_serve_params(cfg, "e4m3", seed=0)
    dparams = random_serve_params(dcfg, "e4m3", seed=1)
    gen = torch.Generator(device="cuda").manual_seed(31)
    T = SPEC_K + 1
    result, problems = {}, []

    # (a) score_tokens_paged, kernels against plain: 8 slots (M = 40, K3's
    # decode form; one padding row, ragged valid counts) and 64 (M = 320,
    # the prefill route).  Drops must leave every other pool byte as it was.
    va = {}
    for batch in (SERVE_SLOTS, BENCH_BATCH):
        paged, pos = spec_pool(cfg, batch, gen)
        toks = torch.randint(1, cfg.vocab_size, (batch, T), device="cuda",
                             generator=gen, dtype=torch.int32)
        valid = torch.full((batch,), T, device="cuda", dtype=torch.int32)
        slots = torch.arange(batch, device="cuda", dtype=torch.int32)
        if batch == SERVE_SLOTS:
            valid[2], valid[4] = 3, 1
            slots[-1] = batch                      # a padding row
        before = paged.pool.clone()
        plain = clone_pool(paged)
        routes0 = dict(qmatmul.dequant_routes)
        lk, paged = spec.score_tokens_paged(params, paged, toks, pos, scfg,
                                            valid_t=valid, slots=slots)
        routes = {k: qmatmul.dequant_routes[k] - routes0[k] for k in routes0}
        lp, plain = with_plain_kernels(lambda: spec.score_tokens_paged(
            params, plain, toks, pos, scfg, valid_t=valid, slots=slots))
        # the positions each live row may write: pos .. pos + valid - 1
        written = torch.zeros((paged.n_pages, PAGE), dtype=torch.bool,
                              device="cuda")
        for b in range(batch):
            if int(slots[b]) >= batch:
                continue
            for t in range(int(valid[b])):
                p = SPEC_POS + t
                written[int(paged.page_table[int(slots[b]), p // PAGE]),
                        p % PAGE] = True
        shape = (paged.n_pages, 2, L, PAGE, KV, D)
        changed = (paged.pool != before).reshape(shape).any(
            dim=(1, 2, 4, 5))
        stray = int((changed & ~written).sum())

        def rows(c):
            return (c.pool.reshape(shape).permute(0, 3, 1, 2, 4, 5)[written],
                    c.sc.reshape(shape[:-1]).permute(0, 3, 1, 2, 4)[written])

        dist = layer_distance(*rows(paged), *rows(plain))
        same = float((paged.pool == plain.pool).float().mean())
        live = slots < batch
        err = rel_err(lk[live], lp[live])
        want_route = "stream" if batch * T <= 64 else "prefill"
        va[batch] = {"logits_rel_err": err, "pool_bytes_equal": same,
                     "written_rows_by_layer": dist,
                     "stray_writes": stray, "k3_routes": routes,
                     "rows_written": int(written.sum())}
        print(f"spec (a) score_tokens_paged, {batch} slots x T = {T} at "
              f"position {SPEC_POS} (M = {batch * T}): kernels vs plain "
              f"max|logit diff| / max|logit| {err:.3e}, pool bytes equal "
              f"{same:.4f}; the {int(written.sum())} written rows by layer: "
              f"{fmt_layers(dist)}; writes outside them {stray}; "
              f"K3 launches by route {routes}")
        if not err <= SERVE_LOGIT_TOL or not bool(torch.isfinite(lk).all()):
            problems.append(f"score_tokens_paged at {batch} slots: logits "
                            f"differ by {err}")
        problems += layer_problems(
            dist, f"score_tokens_paged at {batch} slots, written rows")
        if same < SERVE_RING_EQUAL or stray:
            problems.append(f"score_tokens_paged at {batch} slots: pool "
                            f"bytes equal {same}, stray writes {stray}")
        if routes[want_route] != 7 * L or sum(routes.values()) != 7 * L:
            problems.append(f"score_tokens_paged at {batch} slots: K3 "
                            f"launches by route {routes}, expected {7 * L} "
                            f"on the {want_route} route")
        del paged, plain, before
    result["a"] = va

    # (b) score_tokens on a one-slot ring (S = 512, head 300): kernels
    # against plain (T ring_store launches), and the JAX property: logits[:,
    # t] against t + 1 plain decode steps, both with the kernels.
    S = SERVE_SEQ
    ring = RingKVCache.create(L, 1, S, KV, D, "int8")
    ring.kv8.copy_(torch.randint(-127, 128, ring.kv8.shape, device="cuda",
                                 generator=gen, dtype=torch.int8))
    ring.sc.uniform_(0.004, 0.02, generator=gen)
    ring.head.fill_(300)

    def ring_copy():
        return RingKVCache(kv8=ring.kv8.clone(), sc=ring.sc.clone(),
                           head=ring.head.clone())

    toks = torch.randint(1, cfg.vocab_size, (1, T), device="cuda",
                         generator=gen, dtype=torch.int32)
    pos = torch.full((1,), SPEC_POS, device="cuda", dtype=torch.int32)
    rk, rp, rs = ring_copy(), ring_copy(), ring_copy()
    inplace.reset_launches()
    lk, rk = spec.score_tokens(params, rk, toks, pos, scfg)
    k6 = inplace.routes["ring_store"]
    lp, rp = with_plain_kernels(lambda: spec.score_tokens(params, rp, toks,
                                                          pos, scfg))
    rows = [(300 + t) % S for t in range(T)]
    dist = layer_distance(rk.kv8[rows], rk.sc[rows], rp.kv8[rows],
                          rp.sc[rows])
    same = float((rk.kv8 == rp.kv8).float().mean())
    untouched = [r for r in range(S) if r not in rows]
    stray = int((rk.kv8[untouched] != ring.kv8[untouched]).sum())
    err = rel_err(lk, lp)
    steps_err = 0.0
    for t in range(T):
        ls, rs = decode_step(params, rs, toks[:, t], pos + t, scfg)
        steps_err = max(steps_err, rel_err(lk[:, t], ls))
    heads = (int(rk.head), int(rp.head), int(rs.head))
    ticket = int(rk.ticket[0])
    print(f"spec (b) score_tokens on a one-slot ring of {S} rows, head 300, "
          f"T = {T}: kernels vs plain {err:.3e}, ring bytes equal "
          f"{same:.4f}, the written rows by layer: {fmt_layers(dist)}, "
          f"bytes changed outside them {stray}, heads (kernels, "
          f"plain, steps) {heads}, ticket {ticket}, {k6} ring_store "
          f"launches; logits[:, t] vs t + 1 decode steps {steps_err:.3e}")
    if max(err, steps_err) > SERVE_LOGIT_TOL:
        problems.append(f"score_tokens: {err} vs plain, {steps_err} vs "
                        "decode steps")
    problems += layer_problems(dist, "score_tokens, written rows")
    if same < SERVE_RING_EQUAL or stray \
            or heads != ((300 + T) % S,) * 3 or ticket or k6 != T:
        problems.append(f"score_tokens ring write: equal {same}, stray "
                        f"{stray}, heads {heads}, ticket {ticket}, {k6} "
                        "launches")
    result["b"] = {"logits_rel_err": err, "vs_decode_steps": steps_err,
                   "ring_bytes_equal": same,
                   "written_rows_by_layer": dist, "heads": heads}
    del ring, rk, rp, rs

    # (c) one greedy round at 8 slots with the independent draft in
    # "kernel" mode: every K4 launch of the draft (D = 64, G = 2) against
    # its plain version within k4_reference's bounds.
    checks = []
    tp, tpos = spec_pool(cfg, SERVE_SLOTS, gen)
    dp, dpos = spec_pool(dcfg, SERVE_SLOTS, gen)
    pend = torch.randint(1, cfg.vocab_size, (SERVE_SLOTS, 2), device="cuda",
                         generator=gen, dtype=torch.int32)
    pend_n = torch.ones(SERVE_SLOTS, device="cuda", dtype=torch.int32)
    zeros = torch.zeros(SERVE_SLOTS, device="cuda")
    with _CheckedK4(checks):
        spec.spec_round(params, tp, dparams, dp, pend, pend_n, tpos, dpos,
                        None, zeros, SPEC_K, scfg, dscfg, any_sampled=False)
    bad = [c for c in checks if not c["ok"]]
    worst = max((c["err_over_bound"] for c in checks), default=0.0)
    print(f"spec (c) one round at {SERVE_SLOTS} slots: {len(checks)} draft K4 "
          f"launches (queries {checks[0]['shape'] if checks else None}, "
          f"{dcfg.n_kv_heads} KV heads, D = {dcfg.head_dim}, G = "
          f"{dcfg.n_heads // dcfg.n_kv_heads}) each against plain within "
          f"k4_reference's bounds: {len(checks) - len(bad)} pass, worst "
          f"|acc diff| / bound {worst:.3f}")
    if len(checks) != SPEC_K * dcfg.n_layers or bad:
        problems.append(f"draft K4: {len(checks)} launches, {len(bad)} "
                        "outside the bounds")
    result["c"] = {"launches": len(checks), "worst_over_bound": worst}
    del tp, dp

    # (d) the served engine: 16 requests sharing a 128-token prefix on 8
    # slots, 32 new tokens each, scored admission, 4 rounds a dispatch; the
    # plain paged engine first, then the independent draft (the counted
    # main path, with one ring speculative_decode), then the self-draft.
    reqs = paged_requests(9, 16, cfg.vocab_size)
    prompts = {r.uid: r.prompt for r in reqs}
    ref, sec_ref, _ = run_paged_server(params, scfg, reqs)

    def served(draft, draft_cfg):
        eng = ServingEngine(params, scfg, n_slots=SERVE_SLOTS,
                            max_seq=SERVE_SEQ, chunk_size=16, use_paged=True,
                            page_size=PAGE, prefix_cache=True,
                            prefix_compute_reuse=True, draft_params=draft,
                            draft_cfg=draft_cfg, k_spec=SPEC_K,
                            spec_rounds_per_dispatch=SPEC_RPD)
        srv = EngineServer(eng).start()
        t0 = time.perf_counter()
        try:
            futs = {r.uid: srv.submit(r)
                    for r in paged_requests(9, 16, cfg.vocab_size)}
            out = {uid: f.result(timeout=900) for uid, f in futs.items()}
        finally:
            srv.stop()
        return out, time.perf_counter() - t0, eng

    qmatmul.reset_launches()
    k4.reset_launches()
    inplace.reset_launches()
    with _Counting(qmatmul, "dequant_matmul_plain", forbid=True), \
            _Counting(k4, "paged_decode_attention_plain", forbid=True), \
            _Counting(inplace, "ring_store_plain", forbid=True):
        out_d, sec_d, eng_d = served(dparams, dscfg)
        ring_out, ring_stats = spec.speculative_decode(
            params, dparams, reqs[0].prompt, SERVE_NEW, scfg, dscfg,
            k_spec=SPEC_K, max_seq=SERVE_SEQ)
    launches = {"dequant_matmul": qmatmul.dequant_routes["stream"],
                "dequant_matmul_prefill": qmatmul.dequant_routes["prefill"],
                "dequant_matmul_general": qmatmul.dequant_routes["general"],
                "paged_decode_attention": k4.launches,
                "ring_store": inplace.routes["ring_store"]}
    out_s, sec_s, eng_s = served(params, scfg)
    n_tok = sum(len(v) for v in ref.values())
    # the plain engine's own tokens through the same rule: the control
    _, ties_ref, bad_ref, band_ref = margin_agree(ref, ref, prompts, params,
                                                  scfg)
    print(f"spec (d) the plain paged engine: 16 requests x {SERVE_NEW} "
          f"tokens in {sec_ref:.2f} s; steps inside the margin band "
          f"{ties_ref:.3f}, tokens inside the band a step {band_ref:.2f} of "
          f"{cfg.vocab_size}, tokens outside it {bad_ref or 'none'}")
    if bad_ref:
        problems.append(f"the plain paged engine's tokens lie outside the "
                        f"margin band: {bad_ref}")
    engines = {}
    for name, out, sec, eng in (("draft", out_d, sec_d, eng_d),
                                ("self-draft", out_s, sec_s, eng_s)):
        parts, ties, bad, band = margin_agree(out, ref, prompts, params,
                                              scfg)
        differ = sum(j is not None for j in parts.values())
        acc = eng.spec_accepted / max(eng.spec_drafted, 1)
        # tokens a slot's round emitted: all but the admission's first
        per_round = (n_tok - len(out)) / max(eng.spec_drafted / SPEC_K, 1)
        engines[name] = {"seconds": sec, "acceptance": acc,
                         "rounds": eng.spec_rounds,
                         "tokens_per_slot_round": per_round,
                         "first_part": parts, "near_tie_share": ties,
                         "tokens_in_band": band,
                         "outside_band": bad,
                         "prefix_tokens_reused": eng.prefix_tokens_reused}
        print(f"spec (d) EngineServer over ServingEngine(paged, prefix cache "
              f"with compute reuse, {name}, k_spec {SPEC_K}, {SPEC_RPD} "
              f"rounds a dispatch): 16 requests x {SERVE_NEW} tokens in "
              f"{sec:.2f} s ({n_tok / sec:.1f} tokens/s; the plain paged "
              f"engine {sec_ref:.2f} s); acceptance {acc:.4f}, "
              f"{eng.spec_rounds} rounds, {per_round:.2f} tokens a slot a "
              f"round; {differ} of 16 token lists part from the plain "
              f"engine's, at {[parts[u] for u in sorted(parts)]}; every "
              f"token teacher-forced: steps inside the margin band "
              f"{ties:.3f}, {band:.2f} tokens inside it a step, tokens "
              f"outside it {bad or 'none'}; prefix "
              f"tokens reused {eng.prefix_tokens_reused}")
        if bad or len(out) != 16:
            problems.append(f"the {name} engine emitted tokens outside the "
                            f"margin band: {bad}")
    print(f"spec (d) launches on the counted run (the draft engine and one "
          f"ring speculative_decode of {len(ring_out)} tokens, acceptance "
          f"{ring_stats.acceptance_rate:.4f}): {launches}; no plain version "
          "called")
    # a self-draft proposes the target's own greedy tokens; only near ties
    # that the verify pass's other summation order flips are rejected, so a
    # broken verify shows as an acceptance near the independent draft's
    if engines["self-draft"]["acceptance"] < 0.5:
        problems.append("the self-draft accepted fewer than half its "
                        "drafts")
    if not all(launches[k] for k in ("dequant_matmul",
                                     "dequant_matmul_prefill",
                                     "paged_decode_attention", "ring_store")):
        problems.append(f"a kernel of the spec path never launched: "
                        f"{launches}")
    result["d"] = {"engines": engines, "plain_seconds": sec_ref,
                   "plain_near_tie_share": ties_ref,
                   "plain_tokens_in_band": band_ref,
                   "launches": launches,
                   "ring_acceptance": ring_stats.acceptance_rate}
    del eng_d, eng_s

    # (e) scored admission: 8 prompts of 256 tokens through
    # prefill_scored_paged (kernels and plain) and prefill_batch_paged.
    B, Tp = SERVE_SLOTS, PREFILL_TOKENS
    prompts_t = torch.randint(1, cfg.vocab_size, (B, Tp), device="cuda",
                              generator=gen, dtype=torch.int32)
    lengths = torch.full((B,), Tp, device="cuda", dtype=torch.int32)
    slots = torch.arange(B, device="cuda", dtype=torch.int32)
    zi = torch.zeros(B, device="cuda", dtype=torch.int32)
    zf = torch.zeros(B, device="cuda")

    def admission_pool():
        from fp8tpu_torch.serve import PagedKVCache
        paged = PagedKVCache.create(B * Tp // PAGE, PAGE, L, B, Tp // PAGE,
                                    KV, D, "int8")
        paged.page_table = torch.arange(B * Tp // PAGE, device="cuda",
                                        dtype=torch.int32).reshape(B, -1)
        return paged

    pk, pp, pd = admission_pool(), admission_pool(), admission_pool()
    fk, pk, _, _ = spec.prefill_scored_paged(params, pk, prompts_t, slots, zi,
                                             lengths, None, zf, zi, zi.clone(),
                                             scfg)
    fp, pp, _, _ = with_plain_kernels(lambda: spec.prefill_scored_paged(
        params, pp, prompts_t, slots, zi, lengths, None, zf, zi, zi.clone(),
        scfg))
    fd, pd, _, _ = prefill_batch_paged(params, pd, prompts_t, slots, lengths,
                                       None, zf, None, None, zi, zi.clone(),
                                       scfg)
    dist_p = layer_distance(pk.pool, pk.sc, pp.pool, pp.sc)
    dist_d = layer_distance(pk.pool, pk.sc, pd.pool, pd.sc)
    same_p = float((pk.pool == pp.pool).float().mean())
    same_d = float((pk.pool == pd.pool).float().mean())
    firsts_ok = True
    for b in range(B):
        if int(fk[b]) == int(fd[b]):
            continue
        firsts_ok &= near_tie(full_logits(params, prompts_t[b], scfg)[-1])
    print(f"spec (e) scored admission of {B} x {Tp} tokens: first tokens "
          f"equal to prefill_batch_paged's {int((fk == fd).sum())} / {B} "
          f"(the rest at near ties: {firsts_ok}), to the plain versions' "
          f"{int((fk == fp).sum())} / {B}; pool bytes equal to the plain "
          f"versions' {same_p:.4f}, by layer: {fmt_layers(dist_p)}; to the "
          f"dense prefill's {same_d:.4f} (it attends to bf16 K/V, the "
          f"scored pass to the quantized pool), by layer: "
          f"{fmt_layers(dist_d)}")
    if not firsts_ok:
        problems.append("scored admission: first tokens part from the "
                        "dense prefill's away from a near tie")
    problems += layer_problems(dist_p, "scored admission vs plain")
    # layer 0's k / v come from the same embedding rows through the same
    # K3 launches on both; deeper layers attend to int8 vs bf16 K/V
    problems += layer_problems(dist_d, "scored admission vs dense prefill",
                               layers=1)
    result["e"] = {"pool_bytes_equal_plain": same_p,
                   "pool_by_layer_plain": dist_p,
                   "pool_bytes_equal_dense": same_d,
                   "pool_by_layer_dense": dist_d,
                   "firsts_equal_dense": int((fk == fd).sum())}
    del pk, pp, pd

    # (f) one spec_rounds dispatch (4 rounds, self-draft) at 8 and 64 slots
    # against a plain paged decode chunk of the same number of tokens.
    timing = {}
    for batch in (SERVE_SLOTS, BENCH_BATCH):
        tp, tpos = spec_pool(cfg, batch, gen)
        dp, dpos = spec_pool(cfg, batch, gen)
        dp.pool.copy_(tp.pool)
        dp.sc.copy_(tp.sc)
        dp.page_table = tp.page_table.clone()
        pend = torch.randint(1, cfg.vocab_size, (batch, 2), device="cuda",
                             generator=gen, dtype=torch.int32)
        pend_n = torch.ones(batch, device="cuda", dtype=torch.int32)
        temp = torch.zeros(batch, device="cuda")

        def dispatch():
            return spec.spec_rounds(params, tp, params, dp, pend, pend_n,
                                    tpos, dpos, None, temp, SPEC_K, SPEC_RPD,
                                    scfg, scfg, any_sampled=False)

        out = dispatch()
        emitted = int((out[1] + 1).sum()) // batch     # tokens a slot
        steps = emitted

        def plain_chunk():
            return decode_steps_paged(params, tp, pend[:, 0], tpos, None,
                                      temp, steps, scfg, greedy_only=True)

        walls = {"spec": [], "plain": []}
        torch.cuda.synchronize()
        for which in ("spec", "plain", "plain", "spec"):
            t0 = time.perf_counter()
            (dispatch if which == "spec" else plain_chunk)()
            torch.cuda.synchronize()
            walls[which].append((time.perf_counter() - t0) * 1e3)
        profs = {}
        for which, fn in (("spec", dispatch), ("plain", plain_chunk)):
            qmatmul.reset_launches()
            k4.reset_launches()
            profs[which] = profile_decode_step(fn, min(walls[which]))
        timing[batch] = {"tokens_a_slot": emitted,
                         "acceptance": float(out[1].float().mean() / SPEC_K),
                         "wall_ms": walls, "profile": profs}
        for which in ("spec", "plain"):
            pr = profs[which]
            print(f"spec (f) {which}: {batch} slots, {emitted} tokens a slot "
                  f"({'one dispatch of ' + str(SPEC_RPD) + ' self-draft rounds' if which == 'spec' else 'a paged decode chunk in kernel mode'}): "
                  f"{min(walls[which]):.3f} ms wall clock, "
                  f"{pr['device_ms']:.3f} ms of kernels in {pr['launches']} "
                  f"launches, device-busy share {pr['busy_share']:.3f}")
            for group, (ms, n) in pr["groups"].items():
                print(f"    {ms:8.3f} ms {n:5d}x  {group}")
        del tp, dp
        torch.cuda.empty_cache()
    result["f"] = timing
    record["spec"] = result
    if problems:
        raise PhaseError("; ".join(problems))
    return launches


def time_spec(record, launches):
    """The spec path's kernels at its own shapes, device time by CUDA-graph
    replay beside the plain version, the bound and a PyTorch call: K3 at M
    = 40 (the 8-slot verify pass, decode form) and M = 320 (64 slots, the
    prefill route) on the gate projection; K4 at the draft's head shape (D
    = 64, G = 2, 8 slots x 444 tokens, int8); K6 writing one row of the
    one-slot target ring.  Returns the kernels line's entries."""
    import torch
    from fp8tpu_torch.kernels import inplace, qmatmul
    from fp8tpu_torch.kernels import paged_attention as k4
    from fp8tpu_torch.tools import device_ms

    params = STATE["e4m3"]
    gen = torch.Generator(device="cuda").manual_seed(32)
    w_stack, s = params["gate8"], params["gates"][0]
    k, n = w_stack.shape[1:]
    state = {"i": 0}

    def rotate():
        state["i"] = (state["i"] + 1) % w_stack.shape[0]
        return w_stack[state["i"]]

    entries, rows = [], {}
    for m, name, key in ((SERVE_SLOTS * (SPEC_K + 1), "dequant_matmul",
                          "dequant_matmul"),
                         (BENCH_BATCH * (SPEC_K + 1), "dequant_matmul_prefill",
                          "dequant_matmul_prefill")):
        x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
        err = float((qmatmul.dequant_matmul(x, w_stack[0], s).float()
                     - qmatmul.dequant_matmul_plain(x, w_stack[0], s).float()
                     ).abs().max())
        t_k = device_ms(lambda: qmatmul.dequant_matmul(x, rotate(), s))
        t_p = cuda_ms(lambda: qmatmul.dequant_matmul_plain(x, rotate(), s),
                      iters=4, warmup=1)
        t_l = device_ms(lambda: torch.matmul(x, rotate().to(torch.bfloat16))
                        * s)
        t_bytes = (2.0 * m * k + k * n + 4.0 * n + 2.0 * m * n) \
            / HBM_BYTES_PER_S * 1e3
        t_ops = 2.0 * m * n * k / BF16_TC_FLOPS * 1e3
        rows[m] = {"ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                   "bound_ms": max(t_bytes, t_ops), "max_abs_err": err}
        print(f"time spec k3 gate {k}x{n} M={m}: kernel {t_k:.4f} ms on the "
              f"device, plain {t_p:.4f} ms, bound {max(t_bytes, t_ops):.4f} "
              f"ms, (x @ w8.to(bf16)) * s {t_l:.4f} ms")
        entries.append({
            "name": f"{name} (speculation, M = {m})", "route": "cuda",
            "source": "fp8tpu_torch/kernels/csrc/w_stream.cuh",
            "replaces": "fp8tpu/kernels/qmatmul.py:87",
            "launches": launches[key], "max_abs_err": err, "ms": t_k,
            "plain_ms": t_p, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": t_l})

    dcfg = draft_serve_config()
    KV, G, D = dcfg.n_kv_heads, dcfg.n_heads // dcfg.n_kv_heads, dcfg.head_dim
    paged, lens = spec_pool(dcfg, SERVE_SLOTS, gen)
    q = (torch.randn(SERVE_SLOTS, KV * G, D, device="cuda", generator=gen)
         * 0.7).to(torch.bfloat16)
    kw = dict(page_size=PAGE, kv_heads=KV)
    args = (q, paged.pool, paged.sc, paged.page_table, lens)
    layer = {"i": 0}

    def kern():
        layer["i"] = (layer["i"] + 1) % dcfg.n_layers
        return k4.paged_decode_attention(*args, layer["i"], **kw)

    got = k4.paged_decode_attention(*args, 1, **kw)
    want = k4.paged_decode_attention_plain(*args, 1, **kw)
    err = float((got[0] - want[0]).abs().max())
    t_k = device_ms(kern)
    t_p = cuda_ms(lambda: k4.paged_decode_attention_plain(*args, 1, **kw),
                  iters=3, warmup=1)
    Tt = SPEC_MP * PAGE
    safe = paged.page_table.long()
    mask = (torch.arange(Tt, device="cuda")[None] < lens[:, None]
            )[:, None, :].repeat_interleave(KV, 0)
    B = SERVE_SLOTS

    def library():
        kk = paged.pool[safe, 0, 1].to(torch.bfloat16).reshape(B, Tt, KV, D)
        vv = paged.pool[safe, 1, 1].to(torch.bfloat16).reshape(B, Tt, KV, D)
        ks = paged.sc[safe, 0, 1].reshape(B, Tt, KV).permute(0, 2, 1)
        vs = paged.sc[safe, 1, 1].reshape(B, Tt, KV).permute(0, 2, 1)
        sc_ = torch.bmm(q.reshape(B * KV, G, D),
                        kk.permute(0, 2, 3, 1).reshape(B * KV, D, Tt),
                        out_dtype=torch.float32) * ks.reshape(B * KV, 1, Tt)
        sc_ = torch.where(mask, sc_, -1e30)
        mm = sc_.amax(-1)
        p = torch.exp(sc_ - mm[..., None])
        pv = (p * vs.reshape(B * KV, 1, Tt)).to(torch.bfloat16)
        return torch.bmm(pv, vv.permute(0, 2, 1, 3).reshape(B * KV, Tt, D),
                         out_dtype=torch.float32), mm, p.sum(-1)

    t_l = device_ms(library)
    tokens = int(lens.sum())
    nbytes = (tokens * KV * (2 * D + 2 * 4) + paged.page_table.numel() * 4
              + lens.numel() * 4 + q.numel() * 2 + B * KV * G * (D + 2) * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * 2 * tokens * KV * G * D / F32_SIMT_FLOPS * 1e3
    print(f"time spec k4 draft head shape (D = {D}, G = {G}, {KV} KV heads, "
          f"{B} slots x {SPEC_POS} tokens, int8): kernel {t_k:.5f} ms on the "
          f"device, plain {t_p:.4f} ms, bound {max(t_bytes, t_ops):.5f} ms, "
          f"gather + upcast + torch.bmm {t_l:.5f} ms")
    entries.append({
        "name": "paged_decode_attention (speculation draft, D = 64, G = 2)",
        "route": "cuda",
        "source": "fp8tpu_torch/kernels/csrc/paged_attention.cu",
        "replaces": "fp8tpu/kernels/paged_attention.py:55",
        "launches": launches["paged_decode_attention"], "max_abs_err": err,
        "ms": t_k, "plain_ms": t_p, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops > t_bytes else "bytes",
        "library_ms": t_l})
    del paged

    cfg = serve_config()
    kv8 = torch.zeros((SERVE_SEQ, 2, cfg.n_layers, cfg.n_kv_heads,
                       cfg.head_dim), dtype=torch.int8, device="cuda")
    sc = torch.ones(kv8.shape[:-1], device="cuda")
    slab8 = torch.randint(-127, 128, kv8.shape[1:], device="cuda",
                          generator=gen, dtype=torch.int8)
    slabs = torch.rand(sc.shape[1:], device="cuda", generator=gen)
    kv8_p, sc_p = kv8.clone(), sc.clone()
    head = torch.tensor(7, device="cuda", dtype=torch.int32)
    head_p = head.clone()
    ticket = torch.zeros(1, device="cuda", dtype=torch.int32)
    inplace.ring_store(kv8, slab8, sc, slabs, head, SERVE_SEQ, ticket)
    inplace.ring_store_plain(kv8_p, slab8, sc_p, slabs, head_p, SERVE_SEQ)
    err = max(float((kv8.short() - kv8_p.short()).abs().max()),
              float((sc - sc_p).abs().max()), abs(int(head) - int(head_p)))
    t_k = device_ms(lambda: inplace.ring_store(kv8, slab8, sc, slabs, head,
                                               SERVE_SEQ, ticket))
    t_p = device_ms(lambda: inplace.ring_store_plain(kv8_p, slab8, sc_p,
                                                     slabs, head_p,
                                                     SERVE_SEQ))
    nbytes = slab8.numel() + 4 * slabs.numel()
    b = 2.0 * nbytes / HBM_BYTES_PER_S * 1e3
    print(f"time spec k6 one row of the one-slot ring ({nbytes} bytes): "
          f"ring_store {t_k:.5f} ms on the device, plain {t_p:.5f} ms, bound "
          f"{b:.6f} ms (bytes)")
    if err:
        raise PhaseError("ring_store at the one-slot ring differs from plain")
    entries.append({
        "name": "ring_store (speculation on the ring, one slot)",
        "route": "cuda", "source": "fp8tpu_torch/kernels/csrc/inplace.cu",
        "replaces": "fp8tpu/kernels/inplace.py:27",
        "launches": launches["ring_store"], "max_abs_err": err, "ms": t_k,
        "plain_ms": t_p, "bound_ms": b, "bound_by": "bytes",
        "library_ms": None})
    record.setdefault("time", {})["spec"] = {"k3": rows}
    return entries


# -- phase moe -------------------------------------------------------------------

MOE_MS = (8, 64, PREFILL_ROWS)     # rows of the expert launches held one by one
MOE_STEPS = 4                      # decode steps held against plain
MOE_PROFILE_STEPS = 8              # steps of the timed batch-64 chunk


def moe_config():
    """The JAX package's MoE decode config (tools/bench_extras.py:270-275):
    vocabulary 32768, d_model 2048, 12 layers, 16 heads / 8 KV heads of
    128, d_ff 5504, 8 experts, top-2, max_seq 1024; nothing is cut (about
    2.45 GB of e4m3 weights: 2.17 GB of experts)."""
    from fp8tpu_torch.models import DecoderConfig
    return DecoderConfig(vocab_size=32768, d_model=2048, n_layers=12,
                         n_heads=16, n_kv_heads=8, d_ff=5504,
                         max_seq_len=1024, n_experts=8, moe_top_k=2)


class _Recording:
    """Keep the arguments and the result of every call of ``module.name``
    while the context is open."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def shim(*a, **kw):
            out = self.orig(*a, **kw)
            self.calls.append((a, kw, out))
            return out

        setattr(self.module, self.name, shim)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class _Routing:
    """Record the top-k experts every MoE FFN call picks for each of its
    tokens (and the router probabilities), while the context is open: the
    kernel and plain runs of one decode step are compared call by call."""

    def __init__(self):
        from fp8tpu_torch.serve import model as smodel
        self.smodel, self.calls = smodel, []

    def __enter__(self):
        import torch
        self.orig = self.smodel._moe_ffn

        def shim(x, xs, mcfg, linear):
            xt = x.reshape(-1, x.shape[-1])
            probs = torch.softmax(self.smodel._dot_f32(
                xt.to(torch.float32), xs["router"]), dim=-1)
            top = torch.sort(probs, dim=-1, descending=True, stable=True)
            self.calls.append((top.indices[:, :mcfg.moe_top_k]
                               .sort(-1).values, top.values))
            return self.orig(x, xs, mcfg, linear)

        self.smodel._moe_ffn = shim
        return self

    def __exit__(self, *exc):
        self.smodel._moe_ffn = self.orig


def routing_flips(got, want, k):
    """Tokens whose expert choice differs between two runs of the same
    calls (one call a layer): {token: (layer, near tie)}, the first one a
    token; a near tie is a choice whose k-th and (k+1)-th probabilities
    (of the reference run) lie within SERVE_LOGIT_TOL of the k-th."""
    flips = {}
    for layer, ((gi, _), (wi, wp)) in enumerate(zip(got.calls, want.calls)):
        for t in (gi != wi).any(-1).nonzero().flatten().tolist():
            if t not in flips:
                gap = float(wp[t, k - 1] - wp[t, k])
                flips[t] = (layer,
                            gap <= SERVE_LOGIT_TOL * float(wp[t, k - 1]))
    return flips


def step_rows(cache, pos0, steps, kv_heads, live, h0=None):
    """The head vectors a run of ``steps`` decode steps wrote, for the
    (step, slot) pairs ``live`` (steps, B) marks: payloads (R, 2, L, KV, D)
    and scales (R, 2, L, KV), the layout ``layer_distance`` reads.  Step i
    of slot b wrote position pos0[b] + i: ring row (h0 + i) mod S of a
    ring, the slot's mapped page of a pool."""
    import torch
    B = pos0.shape[0]
    dev = pos0.device
    i = torch.arange(steps, device=dev)[:, None]
    kv = torch.arange(kv_heads, device=dev)
    if h0 is not None:                          # a ring
        rows = ((h0 + i) % cache.kv8.shape[0])[..., None]     # (steps, 1, 1)
        cols = (torch.arange(B, device=dev)[:, None] * kv_heads + kv)[None]
        pay, sc = cache.kv8[rows, :, :, cols], cache.sc[rows, :, :, cols]
    else:                                       # a paged pool
        p = pos0.long()[None] + i                               # (steps, B)
        page = cache.page_table.long()[torch.arange(B, device=dev)[None],
                                       p // cache.page_size][..., None]
        rows = (p % cache.page_size)[..., None] * kv_heads + kv
        pay, sc = cache.pool[page, :, :, rows], cache.sc[page, :, :, rows]
    # (steps, B, KV, 2, L, ...) -> the live pairs, (R, 2, L, KV, ...)
    return pay[live].permute(0, 2, 3, 1, 4), sc[live].permute(0, 2, 3, 1)


def cache_checks(what, a, b, pos0, steps, kv_heads, live, h0=None,
                 whole_gate=True):
    """The gates on the caches of a kernel run ``a`` and a reference run
    ``b``: the rows the compared steps wrote, layer by layer
    (``layer_problems``), over the (step, slot) pairs ``live``; and, with
    ``whole_gate``, payload bytes of the whole cache at least
    SERVE_RING_EQUAL equal (as serve (b) holds 4 steps; over a 32-step
    chunk the deep layers' bf16 steps alone take it below that, see
    phase_flush).  Returns (whole-cache share, per-layer distances,
    problems)."""
    pa, pb = (a.kv8, b.kv8) if h0 is not None else (a.pool, b.pool)
    whole = float((pa == pb).float().mean())
    ra, sa = step_rows(a, pos0, steps, kv_heads, live, h0)
    rb, sb = step_rows(b, pos0, steps, kv_heads, live, h0)
    dist = layer_distance(ra, sa, rb, sb)
    problems = layer_problems(dist, what)
    if whole_gate and whole < SERVE_RING_EQUAL:
        problems.append(f"{what}: cache payload bytes equal {whole}")
    return whole, dist, problems


def replay_in_band(params, scfg, prompt, tokens, steps):
    """The steps of ``tokens`` (emitted after ``prompt``) whose token lies
    outside the margin band of a teacher-forced replay of the engine's own
    path: a prefill, then one decode step a token on a one-slot ring.  An
    MoE token off the dense forward's band (``margin_agree``) is held to
    this: a routing choice at a near tie can fall one way in the engine's
    decode path and the other in the dense forward, and then moves the
    logits past the band; the replay takes the engine's path."""
    import torch
    from fp8tpu_torch.serve import RingKVCache, decode_step, prefill
    cfg = scfg.model
    ring = RingKVCache.create(cfg.n_layers, 1, SERVE_SEQ, cfg.n_kv_heads,
                              cfg.head_dim, scfg.kv_fmt)
    n = len(prompt)
    pad = torch.tensor(prompt + [0] * (64 - n % 64), device="cuda",
                       dtype=torch.int32)
    logits, ring = prefill(params, ring, pad, 0, n, scfg)
    off = []
    for j in range(max(steps) + 1):
        if j:
            lg, ring = decode_step(params, ring, torch.tensor(
                [tokens[j - 1]], device="cuda", dtype=torch.int32),
                torch.tensor([n + j - 1], device="cuda", dtype=torch.int32),
                scfg)
            logits = lg[0]
        if j in steps:
            lg = logits.float()
            band = 2 * SERVE_LOGIT_TOL * float(lg.abs().max())
            if float(lg.max() - lg[tokens[j]]) > band:
                off.append(j)
    return off


def moe_launch_cases(params, cfg, scfg, int4, gen, rows):
    """Every K3 (K5 for int4) launch of one serving MoE FFN at M in MOE_MS
    against its plain version on its own operands, within K3's bounds
    (gemm_tolerance, and stream_reference over the loop's promoted chunks,
    K = 5504 ending in a partial chunk); returns launches by M."""
    import torch
    from fp8tpu_torch.kernels import int4_matmul as k5
    from fp8tpu_torch.kernels import qmatmul
    from fp8tpu_torch.serve import model as smodel
    sms = qmatmul.sm_count(0)
    xs = smodel._layer_xs(params, 0)
    linear = smodel._make_linear(scfg)
    counts = {}
    module, name = ((k5, "int4_matmul") if int4
                    else (qmatmul, "dequant_matmul"))
    for m in MOE_MS:
        x = torch.randn(m, cfg.d_model, device="cuda", generator=gen
                        ).to(torch.bfloat16)
        with _Recording(module, name) as rec:
            smodel._moe_ffn(x, xs, cfg, linear)
        counts[m] = len(rec.calls)
        for i, (a, kw, got) in enumerate(rec.calls):
            if int4:
                xx, wp, s, group, out_dtype = a
                k, n = 2 * wp.shape[0], wp.shape[1]
                want = k5.int4_matmul_plain(xx, wp, s, group, out_dtype)
                lo, hi = k5.unpack_int4(wp)
                wq = torch.stack([lo, hi], 1).reshape(k, n).to(torch.bfloat16)
                wq = wq * s.to(torch.bfloat16).repeat_interleave(group, 0)
                col = torch.ones(1, n, device="cuda")
                plan = qmatmul.weight_gemm_plan(m, n, k, sms, "int4", xx, wp,
                                                s, group=group)
            else:
                xx, w8, s, out_dtype = a
                k, n = w8.shape
                want = qmatmul.dequant_matmul_plain(xx, w8, s, out_dtype)
                wq, col = w8.float(), s.reshape(1, -1)
                plan = qmatmul.weight_gemm_plan(m, n, k, sms, "w8", xx, w8)
            tol = gemm_tolerance(xx, wq.float().abs(), col, want, out_dtype)
            ref = None if plan.route == "general" else stream_reference(
                xx, wq, col, plan.kper, out_dtype)
            _gemm_case(rows, f"moe {'k5' if int4 else 'k3'} expert "
                       f"{i // 2} {'down' if i % 2 else 'up'} "
                       f"M={m} K={k} N={n} {plan.route}", got, want, tol,
                       reference=ref)
            del ref
        del rec
    return counts


def moe_steps_vs_plain(step, state, clone, steps=MOE_STEPS):
    """``steps`` decode steps of ``step(state, toks, pos)`` (returning
    (logits, state)) with the kernels and with their plain versions on the
    card, from one state, both fed the kernel run's greedy tokens.  Returns
    (worst logit distance over the slots whose routing agreed, the flips
    (slot: (step, layer, near tie)), the final kernel and plain states,
    the (steps, B) mask of the steps each slot ran before its first flip,
    the starting positions)."""
    import torch
    st_k, toks, pos = state
    st_p = clone(st_k)
    pos0 = pos.clone()
    worst, flips = 0.0, {}
    for i in range(steps):
        with _Routing() as rk:
            lk, st_k = step(st_k, toks, pos)
        with _Routing() as rp:
            lp, st_p = with_plain_kernels(lambda: step(st_p, toks, pos))
        for t, (layer, tie) in routing_flips(
                rk, rp, moe_config().moe_top_k).items():
            flips.setdefault(t, (i, layer, tie))
        live = torch.tensor([t not in flips for t in range(lk.shape[0])],
                            device="cuda")
        if live.any():
            d = (lk - lp).abs().amax(-1)[live].max()
            worst = max(worst, float(d / lp[live].abs().max()))
        if not bool(torch.isfinite(lk).all()):
            worst = math.inf
        toks, pos = lk.argmax(-1).to(torch.int32), pos + 1
    live = torch.tensor([[t not in flips or i < flips[t][0]
                          for t in range(toks.shape[0])]
                         for i in range(steps)], device="cuda")
    return worst, flips, st_k, st_p, live, pos0


def phase_moe(record):
    """MoE serving at the JAX package's MoE config: (a) every expert launch
    of one MoE FFN at M = 8, 64, 2048 against plain; (b) 4 decode steps on
    the ring, the paged pool in "kernel" mode and in "ringview" against the
    plain kernels; (c) the same on int4 experts (K5, grouped scales), on
    the ring; (d) 16 requests through the EngineServer, every token inside
    the margin band; (e) launch counts; (f) one timed batch-64 decode
    step."""
    import dataclasses
    import torch
    from fp8tpu_torch.kernels import inplace, int4_matmul, qmatmul
    from fp8tpu_torch.kernels import paged_attention as k4
    from fp8tpu_torch.serve import (EngineServer, PagedKVCache, RingKVCache,
                                    ServeConfig, ServingEngine, decode_step,
                                    decode_step_paged, decode_steps,
                                    prefill_batch, prefill_batch_paged,
                                    random_serve_params)
    from fp8tpu_torch.serve import engine as engine_mod

    cfg = moe_config()
    L, KV, D, E = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.n_experts
    per_step = L * (4 + 2 * E)                      # K3 launches a step
    scfg = ServeConfig(model=cfg, weight_fmt="e4m3", kv_fmt="int8")
    t0 = time.perf_counter()
    params = STATE["moe"] = random_serve_params(cfg, "e4m3", seed=20)
    torch.cuda.synchronize()
    nbytes = {k: v.numel() * v.element_size() for k, v in params.items()}
    experts = sum(v for k, v in nbytes.items() if k.startswith("e"))
    print(f"moe: random e4m3 artifact (vocabulary {cfg.vocab_size}, "
          f"d_model {cfg.d_model}, {L} layers, {cfg.n_heads} / {KV} heads of "
          f"{D}, d_ff {cfg.d_ff}, {E} experts, top-{cfg.moe_top_k}) made in "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{sum(nbytes.values()) / 1e9:.3f} GB, experts "
          f"{experts / 1e9:.3f} GB ({L} layers x {E} experts, each its own "
          f"draw), bf16 embedding {nbytes['embed'] / 1e6:.0f} MB")
    result, problems = {"weight_bytes": sum(nbytes.values())}, []
    gen = torch.Generator(device="cuda").manual_seed(21)

    # (a) every K3 launch of one MoE FFN, one by one.
    rows = []
    counts = moe_launch_cases(params, cfg, scfg, False, gen, rows)
    worst = max(r["max_err_over_bound"] for r in rows)
    f64 = max(r.get("err_over_f64_bound", 0.0) for r in rows)
    print(f"moe (a): one MoE FFN at M in {MOE_MS}: K3 launches {counts} "
          f"(expected {2 * E} each), each against plain: worst err/bound "
          f"{worst:.3e}, worst err/f64 bound {f64:.3e}; "
          f"{sum(not r['ok'] for r in rows)} failed")
    if any(c != 2 * E for c in counts.values()) or not all(
            r["ok"] for r in rows):
        problems.append(f"MoE FFN K3 launches: {counts}, "
                        f"{sum(not r['ok'] for r in rows)} outside K3's "
                        "bounds")
    result["a"] = rows

    # (b) 4 decode steps on the ring, the paged pool in "kernel" mode and
    # in "ringview", kernels against plain.
    def ring_state(prm, sc_):
        g = torch.Generator(device="cuda").manual_seed(22)
        ring = RingKVCache.create(L, SERVE_SLOTS, SERVE_SEQ, KV, D, "int8")
        prompts = torch.randint(1, cfg.vocab_size, (SERVE_SLOTS, 32),
                                device="cuda", generator=g, dtype=torch.int32)
        lengths = torch.randint(8, 33, (SERVE_SLOTS,), device="cuda",
                                generator=g, dtype=torch.int32)
        zi = torch.zeros(SERVE_SLOTS, device="cuda", dtype=torch.int32)
        _, ring, toks, pos = prefill_batch(
            prm, ring, prompts, torch.arange(
                SERVE_SLOTS, device="cuda", dtype=torch.int32), lengths,
            None, torch.zeros(SERVE_SLOTS, device="cuda"), None, None, zi,
            zi.clone(), sc_)
        return ring, toks, pos

    def ring_clone(r):
        return RingKVCache(r.kv8.clone(), r.sc.clone(), r.head.clone())

    def pool_state():
        g = torch.Generator(device="cuda").manual_seed(23)
        paged = PagedKVCache.create(SERVE_SLOTS * 8, PAGE, L, SERVE_SLOTS, 8,
                                    KV, D, "int8")
        paged.page_table = torch.randperm(
            SERVE_SLOTS * 8, device="cuda", generator=g
        ).to(torch.int32).reshape(SERVE_SLOTS, 8)
        prompts = torch.randint(1, cfg.vocab_size, (SERVE_SLOTS, 256),
                                device="cuda", generator=g, dtype=torch.int32)
        lengths = torch.randint(70, 257, (SERVE_SLOTS,), device="cuda",
                                generator=g, dtype=torch.int32)
        zi = torch.zeros(SERVE_SLOTS, device="cuda", dtype=torch.int32)
        _, paged, toks, pos = prefill_batch_paged(
            params, paged, prompts, torch.arange(
                SERVE_SLOTS, device="cuda", dtype=torch.int32), lengths,
            None, torch.zeros(SERVE_SLOTS, device="cuda"), None, None, zi,
            zi.clone(), scfg)
        return paged, toks, pos

    kcfg = dataclasses.replace(scfg, paged_decode_impl="kernel")
    rcfg = dataclasses.replace(scfg, paged_decode_impl="ringview")
    paths = {
        "ring": (lambda st, t, p: decode_step(params, st, t, p, scfg),
                 lambda: ring_state(params, scfg), ring_clone),
        "paged kernel": (lambda st, t, p: decode_step_paged(params, st, t, p,
                                                            kcfg),
                         pool_state, clone_pool),
        "paged ringview": (lambda st, t, p: decode_step_paged(params, st, t,
                                                              p, rcfg),
                           pool_state, clone_pool),
    }
    result["b"] = {}
    for name, (step, make, clone) in paths.items():
        state = make()
        h0 = int(state[0].head) if name == "ring" else None
        qmatmul.reset_launches()
        k4.reset_launches()
        inplace.reset_launches()
        worst, flips, st_k, st_p, live, pos0 = moe_steps_vs_plain(
            step, state, clone)
        k3 = qmatmul.dequant_launches / MOE_STEPS
        k4_n, k6_n = k4.launches / MOE_STEPS, inplace.launches / MOE_STEPS
        same, dist, bad = cache_checks(f"MoE {name}", st_k, st_p, pos0,
                                       MOE_STEPS, KV, live, h0)
        off_tie = {t: f for t, f in flips.items() if not f[2]}
        print(f"moe (b) {name}: {MOE_STEPS} decode steps at "
              f"{SERVE_SLOTS} slots, kernels vs plain on the card: "
              f"max|logit diff| / max|logit| {worst:.3e} (tolerance "
              f"{SERVE_LOGIT_TOL}), cache payload bytes equal {same:.4f} "
              f"(at least {SERVE_RING_EQUAL}); the rows the steps wrote, "
              f"by layer: {fmt_layers(dist)}; routing flips (slot: step, "
              f"layer, near tie) {flips or 'none'}; per step K3 {k3:.1f}, "
              f"K4 {k4_n:.1f}, K6 {k6_n:.1f}")
        problems += bad
        if worst > SERVE_LOGIT_TOL or off_tie:
            problems.append(f"MoE {name}: logits {worst}, routing flips off "
                            f"a near tie {off_tie}")
        want = {"ring": (per_step, 0, 1), "paged kernel": (per_step, L, 0),
                "paged ringview": (per_step, 0, 0)}[name]
        if (k3, k4_n, k6_n) != want:
            problems.append(f"MoE {name}: K3 / K4 / K6 launches a step "
                            f"{(k3, k4_n, k6_n)}, expected {want}")
        result["b"][name] = {"max_rel_logit_diff": worst,
                             "payload_bytes_equal": same,
                             "written_rows_by_layer": dist,
                             "routing_flips": flips,
                             "launches_per_step": [k3, k4_n, k6_n]}
        if name == "paged kernel":
            STATE["moe_pool"] = st_k
            k4_launches = k4.launches
        del state, st_k, st_p

    # (c) int4 experts (K5, grouped scales): every launch of one MoE FFN,
    # and 4 ring decode steps against plain.  Scales of a trained size
    # (dequantized weights of std ~0.02, as the e4m3 draw).
    params4 = random_serve_params(cfg, "int4", seed=24)
    for k in [k for k in params4 if k.endswith("s") and k != "embed_s"]:
        params4[k] = params4[k] * 0.005
    scfg4 = ServeConfig(model=cfg, weight_fmt="int4", kv_fmt="int8")
    rows4 = []
    counts4 = moe_launch_cases(params4, cfg, scfg4, True, gen, rows4)
    state = ring_state(params4, scfg4)
    h0 = int(state[0].head)
    int4_matmul.reset_launches()
    worst4, flips4, st_k, st_p, live, pos0 = moe_steps_vs_plain(
        lambda st, t, p: decode_step(params4, st, t, p, scfg4), state,
        ring_clone)
    k5_launches = int4_matmul.launches
    same4, dist4, bad4 = cache_checks("MoE int4 ring", st_k, st_p, pos0,
                                      MOE_STEPS, KV, live, h0)
    print(f"moe (c): int4 experts (groups of 128: G = "
          f"{params4['eups'].shape[2]} up, {params4['edowns'].shape[2]} "
          f"down): one MoE FFN's K5 launches {counts4}, worst err/bound "
          f"{max((r['max_err_over_bound'] for r in rows4), default=0):.3e}, "
          f"f64 {max((r.get('err_over_f64_bound', 0) for r in rows4), default=0):.3e}, "
          f"{sum(not r['ok'] for r in rows4)} failed; {MOE_STEPS} ring "
          f"decode steps vs plain: {worst4:.3e}, ring bytes equal "
          f"{same4:.4f}, the rows the steps wrote by layer: "
          f"{fmt_layers(dist4)}; routing flips {flips4 or 'none'}; "
          f"{k5_launches / MOE_STEPS:.1f} K5 launches a step")
    if (any(c != 2 * E for c in counts4.values())
            or not all(r["ok"] for r in rows4) or worst4 > SERVE_LOGIT_TOL
            or bad4 or any(not f[2] for f in flips4.values())
            or k5_launches != per_step * MOE_STEPS):
        problems.append(f"MoE int4: launches {counts4} / {k5_launches}, "
                        f"logits {worst4}, ring bytes {same4}, flips "
                        f"{flips4}")
    result["c"] = {"rows": rows4, "max_rel_logit_diff": worst4,
                   "ring_bytes_equal": same4, "written_rows_by_layer": dist4,
                   "routing_flips": flips4}
    STATE["moe_int4"] = params4
    del st_k, st_p

    # (d) the served main path: 16 requests through the EngineServer on 8
    # slots, counted; then the same requests with the plain kernels, and
    # every token of the kernel run teacher-forced inside the margin band.
    reqs = serve_requests(25, 16, cfg.vocab_size)
    prompts = {r.uid: r.prompt for r in reqs}

    def serve_moe():
        eng = ServingEngine(params, scfg, n_slots=SERVE_SLOTS,
                            max_seq=SERVE_SEQ, chunk_size=16)
        srv = EngineServer(eng).start()
        t = time.perf_counter()
        try:
            futs = {r.uid: srv.submit(dataclasses.replace(r)) for r in reqs}
            out = {u: f.result(timeout=600) for u, f in futs.items()}
        finally:
            srv.stop()
        return out, time.perf_counter() - t

    qmatmul.reset_launches()
    inplace.reset_launches()
    with _Counting(engine_mod, "decode_chunk", steps_arg=6) as dc, \
            _Counting(engine_mod, "prefill_batch") as pb, \
            _Counting(qmatmul, "dequant_matmul_plain", forbid=True), \
            _Counting(inplace, "ring_store_plain", forbid=True):
        out, seconds = serve_moe()
    launches = {"moe_dequant_matmul": qmatmul.dequant_routes["stream"],
                "moe_dequant_matmul_prefill": qmatmul.dequant_routes["prefill"],
                "moe_ring_store": inplace.routes["ring_store"],
                "moe_int4_matmul": k5_launches,
                "moe_paged_decode_attention": k4_launches}
    k3_step = (qmatmul.dequant_launches - per_step * pb.calls) / dc.steps
    k6_step = inplace.routes["ring_store"] / dc.steps
    ref, seconds_p = with_plain_kernels(serve_moe)
    parts, ties, dense_off, band = margin_agree(out, ref, prompts, params,
                                                scfg)
    bad = {u: s if isinstance(s, str) else replay_in_band(
        params, scfg, prompts[u], out[u], s) for u, s in dense_off.items()}
    bad = {u: s for u, s in bad.items() if s}
    n_tok = sum(len(v) for v in out.values())
    print(f"moe (d): 16 requests x {SERVE_NEW} tokens through EngineServer "
          f"({SERVE_SLOTS} slots, ring {SERVE_SEQ}, chunks of 16): {n_tok} "
          f"tokens in {seconds:.2f} s ({n_tok / seconds:.1f} tokens/s; the "
          f"plain kernels' run {seconds_p:.2f} s); {dc.steps} decode steps in "
          f"{dc.calls} chunks, {pb.calls} prefills; against the plain run: "
          f"lists parting {sum(j is not None for j in parts.values())} of 16, "
          f"steps inside the margin band {ties:.3f}, tokens inside the band "
          f"a step {band:.2f}; tokens outside the dense forward's band "
          f"{dense_off or 'none'}, of them outside the band of a replay of "
          f"the engine's path {bad or 'none'}")
    print(f"moe (e): launches {launches}: K3 {k3_step:.1f} and K6 "
          f"{k6_step:.1f} a ring decode step (expected {per_step} = {L} x (4 "
          f"+ 2 x {E}) and 1), K4 {L} a paged step (b), K5 {per_step} a "
          f"step on int4 experts (c); no plain version called")
    if any(len(v) != SERVE_NEW for v in out.values()) or len(out) != 16:
        problems.append("an MoE request did not finish with its budget")
    if bad:
        problems.append(f"MoE engine tokens outside the margin band: {bad}")
    if k3_step != per_step or k6_step != 1 or qmatmul.dequant_routes[
            "general"]:
        problems.append(f"MoE engine: K3 / K6 a step {k3_step} / {k6_step}, "
                        f"routes {dict(qmatmul.dequant_routes)}")
    result["d"] = {"tokens": n_tok, "seconds": seconds,
                   "plain_seconds": seconds_p, "decode_steps": dc.steps,
                   "prefills": pb.calls, "first_part": parts,
                   "near_tie_share": ties, "tokens_in_band": band,
                   "outside_dense_band": dense_off, "outside_band": bad,
                   "launches": launches,
                   "k3_per_step": k3_step, "k6_per_step": k6_step}

    # (f) one timed decode step at batch 64, position 444, ring of 512:
    # wall clock of an 8-step chunk, and a profile of one step.
    ring = RingKVCache.create(L, BENCH_BATCH, BENCH_CACHE, KV, D, "int8")
    ring.kv8.copy_(torch.randint(-127, 128, ring.kv8.shape, device="cuda",
                                 generator=gen, dtype=torch.int8))
    ring.sc.uniform_(0.004, 0.02, generator=gen)
    ring.head.fill_(BENCH_WARM_POS)
    toks = torch.randint(1, cfg.vocab_size, (BENCH_BATCH,), device="cuda",
                         generator=gen, dtype=torch.int32)
    pos = torch.full((BENCH_BATCH,), BENCH_WARM_POS, device="cuda",
                     dtype=torch.int32)
    temp = torch.zeros(BENCH_BATCH, device="cuda")

    def chunk(n):
        out_, _ = decode_steps(params, ring, toks, pos, None, temp, n, scfg,
                               greedy_only=True)
        return out_

    chunk(2)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t = time.perf_counter()
        int(chunk(MOE_PROFILE_STEPS).sum())
        walls.append((time.perf_counter() - t) / MOE_PROFILE_STEPS * 1e3)
    prof = profile_decode_step(lambda: chunk(1), min(walls))
    k3_ms = prof["groups"].get("K3/K5 weight GEMM (hand-written)",
                               (0.0, 0))[0]
    kv_bytes = BENCH_BATCH * BENCH_WARM_POS * L * 2 * KV * (D + 4)
    bound = (sum(nbytes.values()) + kv_bytes) / HBM_BYTES_PER_S * 1e3
    dense = record.get("serve", {}).get("d", {}).get("fp8")
    dense_txt = (f"{dense['step_ms']:.3f} ms wall, "
                 f"{dense['profile']['device_ms']:.3f} ms of kernels "
                 f"(busy {dense['profile']['busy_share']:.3f})"
                 if dense else "not run in this call (the serve phase)")
    print(f"moe (f): one decode step at batch {BENCH_BATCH}, position "
          f"{BENCH_WARM_POS}, ring {BENCH_CACHE}: {min(walls):.3f} ms wall "
          f"(chunks of {MOE_PROFILE_STEPS}: {[round(w, 3) for w in walls]}), "
          f"{prof['device_ms']:.3f} ms of kernels in {prof['launches']} "
          f"launches, device-busy share {prof['busy_share']:.3f}, K3 "
          f"{k3_ms:.3f} ms ({k3_ms / prof['device_ms']:.3f} of the kernels); "
          f"byte bound {bound:.3f} ms ({(sum(nbytes.values()) + kv_bytes) / 1e9:.3f} "
          f"GB: weights and the KV read); the dense serve config's step: "
          f"{dense_txt}")
    for group, (ms, n) in prof["groups"].items():
        print(f"    {ms:8.3f} ms {n:5d}x  {group}")
    result["f"] = {"wall_ms": walls, "profile": prof, "k3_ms": k3_ms,
                   "bound_ms": bound}
    del ring
    record["moe"] = result
    torch.cuda.empty_cache()
    if problems:
        raise PhaseError("; ".join(problems))
    return launches


def k4_library(q, paged, lens, layer, kv_heads):
    """K4's (acc, m, l) by library calls: the slots' pages gathered, upcast
    and scaled to f32, the score and context products as torch.matmul
    (IEEE f32), masked past ``lens``."""
    import torch
    from fp8tpu_torch._device import full_fp32
    B, KVG, D = q.shape
    KV, G, P = kv_heads, KVG // kv_heads, paged.page_size
    pages = paged.page_table.clamp(min=0).long()            # (B, MP)
    T = pages.shape[1] * P
    kv = paged.pool[pages, :, layer].to(torch.float32)      # (B, MP, 2, P KV, D)
    sc = paged.sc[pages, :, layer]                          # (B, MP, 2, P KV)
    kv = (kv * sc[..., None]).reshape(B, -1, 2, P, KV, D)
    kv = kv.permute(0, 2, 4, 1, 3, 5).reshape(B, 2, KV, T, D)
    qh = q.to(torch.float32).reshape(B, KV, G, D)
    with full_fp32():
        s = torch.matmul(qh, kv[:, 0].transpose(-1, -2))    # (B, KV, G, T)
        valid = torch.arange(T, device=q.device)[None] < lens[:, None]
        s = torch.where(valid[:, None, None], s, -math.inf)
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        acc = torch.matmul(p, kv[:, 1])
    return acc.reshape(B, KVG, D), m.reshape(B, KVG), p.sum(-1).reshape(B, KVG)


def time_moe(record, launches):
    """The MoE path's kernels at its own shapes, beside the plain version,
    the bound and a PyTorch call: K3 on the expert up projection (2048 x
    5504) at M = 8 (decode form) and M = 2048 (prefill route), rotating
    over the 96 expert stacks so a launch finds its weights in device
    memory; K5 on the int4 expert (groups of 128); K4 at G = 2 on the (b)
    pool; K6 one row of the MoE ring at 8 slots.  Returns the kernels
    line's entries."""
    import torch
    from fp8tpu_torch.kernels import inplace, int4_matmul, qmatmul
    from fp8tpu_torch.kernels import paged_attention as k4
    from fp8tpu_torch.tools import device_ms

    cfg = moe_config()
    params, params4 = STATE["moe"], STATE["moe_int4"]
    gen = torch.Generator(device="cuda").manual_seed(26)
    entries, rows = [], []
    w_stack = params["eup8"].reshape(-1, *params["eup8"].shape[2:])
    s_stack = params["eups"].reshape(-1, params["eups"].shape[-1])
    k, n = w_stack.shape[1:]

    def rotating(fn, count):
        state = {"i": 0}

        def call():
            state["i"] = (state["i"] + 1) % count
            return fn(state["i"])
        return call

    for m, name, key in ((SERVE_SLOTS, "dequant_matmul (MoE experts)",
                          "moe_dequant_matmul"),
                         (PREFILL_ROWS, "dequant_matmul_prefill (MoE "
                          "experts)", "moe_dequant_matmul_prefill")):
        x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
        got = qmatmul.dequant_matmul(x, w_stack[0], s_stack[0])
        want = qmatmul.dequant_matmul_plain(x, w_stack[0], s_stack[0])
        err = float((got.float() - want.float()).abs().max())
        t_k = device_ms(rotating(lambda i: qmatmul.dequant_matmul(
            x, w_stack[i], s_stack[i]), w_stack.shape[0]))
        t_p = cuda_ms(rotating(lambda i: qmatmul.dequant_matmul_plain(
            x, w_stack[i], s_stack[i]), w_stack.shape[0]), iters=4, warmup=1)
        t_l = device_ms(rotating(lambda i: torch.matmul(
            x, w_stack[i].to(torch.bfloat16)) * s_stack[i],
            w_stack.shape[0]))
        t_bytes = (2.0 * m * k + k * n + 4.0 * n + 2.0 * m * n) \
            / HBM_BYTES_PER_S * 1e3
        t_ops = 2.0 * m * n * k / BF16_TC_FLOPS * 1e3
        b, by = max(t_bytes, t_ops), ("operations" if t_ops > t_bytes
                                      else "bytes")
        rows.append({"kernel": "K3", "m": m, "k": k, "n": n, "ms": t_k,
                     "plain_ms": t_p, "library_ms": t_l, "bound_ms": b,
                     "bound_by": by, "max_abs_err": err})
        print(f"time moe k3 expert up {k}x{n} M={m}: kernel {t_k:.4f} ms on "
              f"the device ({k * n / t_k / 1e6:.0f} GB/s of payload), plain "
              f"{t_p:.4f} ms, bound {b:.4f} ms ({by}), (x @ w8.to(bf16)) * "
              f"s {t_l:.4f} ms")
        entries.append({
            "name": name, "route": "cuda",
            "source": "fp8tpu_torch/kernels/csrc/dequant_matmul.cu",
            "replaces": "fp8tpu/kernels/qmatmul.py:87",
            "launches": launches[key], "max_abs_err": err, "ms": t_k,
            "plain_ms": t_p, "bound_ms": b, "bound_by": by,
            "library_ms": t_l})

    # K5 on the int4 expert up projection at the served slots
    w4 = params4["eup8"].reshape(-1, *params4["eup8"].shape[2:])
    s4 = params4["eups"].reshape(-1, *params4["eups"].shape[2:])
    group = k // s4.shape[1]
    x = torch.randn(SERVE_SLOTS, k, device="cuda", generator=gen
                    ).to(torch.bfloat16)
    got = int4_matmul.int4_matmul(x, w4[0], s4[0], group)
    want = int4_matmul.int4_matmul_plain(x, w4[0], s4[0], group)
    err = float((got.float() - want.float()).abs().max())
    t_k = device_ms(rotating(lambda i: int4_matmul.int4_matmul(
        x, w4[i], s4[i], group), w4.shape[0]))
    t_p = cuda_ms(rotating(lambda i: int4_matmul.int4_matmul_plain(
        x, w4[i], s4[i], group), w4.shape[0]), iters=4, warmup=1)
    lo, hi = int4_matmul.unpack_int4(w4[:4])
    w_bf16 = torch.stack([lo, hi], 2).reshape(4, k, n).to(torch.bfloat16)
    t_l = device_ms(rotating(lambda i: torch.matmul(x, w_bf16[i]), 4))
    b = (2.0 * SERVE_SLOTS * k + k * n / 2.0 + 4.0 * s4[0].numel()
         + 2.0 * SERVE_SLOTS * n) / HBM_BYTES_PER_S * 1e3
    print(f"time moe k5 int4 expert up {k}x{n} group {group} M={SERVE_SLOTS}:"
          f" kernel {t_k:.4f} ms on the device, plain {t_p:.4f} ms, bound "
          f"{b:.4f} ms (bytes), torch.matmul on a pre-unpacked bf16 weight "
          f"{t_l:.4f} ms")
    rows.append({"kernel": "K5", "m": SERVE_SLOTS, "k": k, "n": n,
                 "group": group, "ms": t_k, "plain_ms": t_p,
                 "library_ms": t_l, "bound_ms": b, "max_abs_err": err})
    entries.append({
        "name": "int4_matmul (MoE experts)", "route": "cuda",
        "source": "fp8tpu_torch/kernels/csrc/int4_matmul.cu",
        "replaces": "fp8tpu/kernels/int4_matmul.py:57",
        "launches": launches["moe_int4_matmul"], "max_abs_err": err,
        "ms": t_k, "plain_ms": t_p, "bound_ms": b, "bound_by": "bytes",
        "library_ms": t_l})
    del w_bf16

    # K4 at G = 2 on the pool of (b), one layer a launch in turn
    paged = STATE.pop("moe_pool")
    KV, D, L = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    G = cfg.n_heads // KV
    B = paged.n_slots
    lens = torch.full((B,), 200, device="cuda", dtype=torch.int32)
    q = (torch.randn(B, KV * G, D, device="cuda", generator=gen) * 0.7
         ).to(torch.bfloat16)
    kw = dict(page_size=paged.page_size, kv_heads=KV)
    got = k4.paged_decode_attention(q, paged.pool, paged.sc, paged.page_table,
                                    lens, L - 1, **kw)
    want = k4.paged_decode_attention_plain(q, paged.pool, paged.sc,
                                           paged.page_table, lens, L - 1, **kw)
    err = float((got[0] - want[0]).abs().max())
    t_k = device_ms(rotating(lambda i: k4.paged_decode_attention(
        q, paged.pool, paged.sc, paged.page_table, lens, i, **kw), L))
    t_p = cuda_ms(lambda: k4.paged_decode_attention_plain(
        q, paged.pool, paged.sc, paged.page_table, lens, L - 1, **kw), iters=3,
        warmup=1)
    tokens = int(lens.sum())
    nb = (tokens * KV * (2 * D + 2 * 4) + paged.page_table.numel() * 4
          + B * 4 + q.numel() * 2 + B * KV * G * (D + 2) * 4)
    t_bytes = nb / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * 2 * tokens * KV * G * D / F32_SIMT_FLOPS * 1e3
    b, by = max(t_bytes, t_ops), ("operations" if t_ops > t_bytes
                                  else "bytes")
    lib = k4_library(q, paged, lens, L - 1, KV)
    lib_err = float((lib[0] - want[0]).abs().max())
    t_l = device_ms(lambda: k4_library(q, paged, lens, L - 1, KV))
    print(f"time moe k4 G={G}: {B} slots x 200 tokens, int8 pool, one layer: "
          f"kernel {t_k:.5f} ms on the device, plain {t_p:.4f} ms, bound "
          f"{b:.5f} ms ({by}); gather + upcast + torch.matmul {t_l:.5f} ms "
          f"(|acc - plain| {lib_err:.3e})")
    rows.append({"kernel": "K4", "batch": B, "tokens": tokens, "ms": t_k,
                 "plain_ms": t_p, "bound_ms": b, "bound_by": by,
                 "library_ms": t_l, "max_abs_err": err})
    entries.append({
        "name": "paged_decode_attention (MoE, G = 2)", "route": "cuda",
        "source": "fp8tpu_torch/kernels/csrc/paged_attention.cu",
        "replaces": "fp8tpu/kernels/paged_attention.py:55",
        "launches": launches["moe_paged_decode_attention"],
        "max_abs_err": err, "ms": t_k, "plain_ms": t_p, "bound_ms": b,
        "bound_by": by, "library_ms": t_l})
    del paged

    # K6: one decode step's row of the MoE ring at the served slots
    bk = SERVE_SLOTS * KV
    kv8 = torch.zeros((SERVE_SEQ, 2, L, bk, D), dtype=torch.int8,
                      device="cuda")
    sc = torch.ones((SERVE_SEQ, 2, L, bk), device="cuda")
    kv8_p, sc_p = kv8.clone(), sc.clone()
    slab8 = torch.randint(-127, 128, kv8.shape[1:], device="cuda",
                          generator=gen, dtype=torch.int8)
    slabs = torch.rand(sc.shape[1:], device="cuda", generator=gen)
    head = torch.tensor(SERVE_SEQ - 1, device="cuda", dtype=torch.int32)
    head_p = head.clone()
    ticket = torch.zeros(1, device="cuda", dtype=torch.int32)
    inplace.ring_store(kv8, slab8, sc, slabs, head, SERVE_SEQ, ticket)
    inplace.ring_store_plain(kv8_p, slab8, sc_p, slabs, head_p, SERVE_SEQ)
    err = float(max((kv8.to(torch.int16) - kv8_p.to(torch.int16)).abs().max(),
                    (sc - sc_p).abs().max(), abs(int(head) - int(head_p))))
    t_k = device_ms(lambda: inplace.ring_store(kv8, slab8, sc, slabs, head,
                                               SERVE_SEQ, ticket))
    t_p = device_ms(lambda: inplace.ring_store_plain(kv8_p, slab8, sc_p,
                                                     slabs, head_p,
                                                     SERVE_SEQ))
    b = 2.0 * (slab8.numel() + 4 * slabs.numel()) / HBM_BYTES_PER_S * 1e3
    print(f"time moe k6 one row of the MoE ring ({SERVE_SLOTS} slots): "
          f"ring_store {t_k:.5f} ms on the device, plain {t_p:.5f} ms, bound "
          f"{b:.5f} ms (bytes)")
    if err:
        raise PhaseError("ring_store at the MoE ring differs from plain")
    rows.append({"kernel": "K6", "ms": t_k, "plain_ms": t_p, "bound_ms": b,
                 "max_abs_err": err})
    entries.append({
        "name": "ring_store (MoE ring)", "route": "cuda",
        "source": "fp8tpu_torch/kernels/csrc/inplace.cu",
        "replaces": "fp8tpu/kernels/inplace.py:27",
        "launches": launches["moe_ring_store"], "max_abs_err": err,
        "ms": t_k, "plain_ms": t_p, "bound_ms": b, "bound_by": "bytes",
        "library_ms": None})
    record.setdefault("time", {})["moe"] = rows
    STATE.pop("moe")
    STATE.pop("moe_int4")
    torch.cuda.empty_cache()
    return entries


# -- phase w8a8 ----------------------------------------------------------------

FP8_TC_FLOPS = 1979e12         # H100 SXM dense fp8 tensor-core rate
# The W8A8 shapes: the four dense serving linears (q/o, k/v, gate/up, down)
# and the MoE config's expert up and down.
W8A8_KN = [(4096, 4096), (4096, 1024), (4096, 11008), (11008, 4096),
           (2048, 5504), (5504, 2048)]
W8A8_MS = (1, 8, 9, 16, 17, 63, 64, 65, 128, 512, 700, 2048)
P2_MS = (1, 8, 64, 512, 2048)
P2_KS = (4096, 11008, 2048, 5504, 1001)
# Above this many rows the plain version and the f64 product are taken on
# the first W8A8_COLS output columns (8 column tiles, every row tile): the
# full-output f32 and f64 products of 84 launches would take minutes.
W8A8_SLICE_M = 512
W8A8_COLS = 1024
W8A8_STEPS = 4                 # decode steps held against plain
# forced_step's limit on an e4m3 direct layer's output (the int8 route's
# is SERVE_LOGIT_TOL): fp8 tensor-core sums keep 13 bits below a k32 step's
# largest addend, and W8A8 turns such differences into whole e4m3 code
# flips (trap 49), so on these draws a sound fp8 GEMM's layers (P1 at chunks
# of 1, 2 or 4 k32 steps, cuBLASLt's fp8 GEMM) lie up to 6.0e-2 of
# max|out| from the f32 plain version, and the f32-grade exact-sum order up
# to 3.3e-2 (PERF.md §6, PR 14).  Each run prints the cuBLASLt control.
W8A8_FP8_LAYER_TOL = 7.5e-2
# N not a multiple of 128 (a block's last column tile partly outside N):
# (M, K, N) on both forms
W8A8_RAGGED = ((8, 4096, 272), (700, 4096, 272), (65, 2048, 48))
# K3's int8 route on shapes TMA cannot read (K % 8 != 0): the general
# kernel (w_gemm.cuh) on f16 codes, both of its row tiles
W8A8_GENERAL = ((8, 1001, 272), (100, 1001, 48))
W8A8_PROBE = (344, 64, 16, 8, 4, 2, 1)   # k32 steps a chunk (344: all of K)


def p2_edge_rows(k: int):
    """Rows of bf16 (R, k) at the edges of P2's rules: a zero row, rows of
    bf16 subnormals (flushed: scale 1, codes 0), +-bf16 max with -0, +inf
    and -inf rows, a NaN row, a row whose amax lies below 448 2^-126 (the
    tiny-amax row: the port keeps the subnormal scale), a row of values
    around the e4m3 rounding ties, and a normal row."""
    import torch
    rows = torch.zeros(9, k)
    rows[1, ::3] = 2.0 ** -130
    rows[1, 1::3] = -(2.0 ** -133)
    rows[2, 0], rows[2, 1], rows[2, 2] = 3.3895313892515355e38, -0.0, \
        -3.3895313892515355e38
    rows[2, 3:] = torch.linspace(-1e38, 1e38, k - 3)
    rows[3, :] = 1.0
    rows[3, 5] = math.inf
    rows[4, :] = -2.0
    rows[4, 7] = -math.inf
    rows[5, :] = 0.5
    rows[5, 9] = math.nan
    rows[6, :4] = torch.tensor([1e-37, -3e-38, 0.0, 5e-38])
    rows[7, :] = torch.arange(k) * (448.0 / k) + 0.0625
    rows[8, :] = torch.linspace(-3.0, 3.0, k)
    return rows.to(torch.bfloat16)


def p2_case(rows, label, x, fmt="e4m3", codes_dtype=None):
    """P2 on the card against its plain version on the CPU (the host's NaN
    rules decide): codes and scales bit for bit, and a second launch; with
    ``codes_dtype`` (the codes' f16 values) also against the byte output's
    values on the card (``qmatmul.codes_as``)."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    q, s = qmatmul.quantize_rows(x, fmt, codes_dtype)
    q2, s2 = qmatmul.quantize_rows(x, fmt, codes_dtype)
    wq, ws = qmatmul.quantize_rows_plain(x.cpu(), fmt, codes_dtype)
    codes = int((q.view(torch.uint8).cpu() != wq.view(torch.uint8)).sum())
    scales = int((s.cpu().view(torch.int32) != ws.view(torch.int32)).sum())
    again = int((q2.view(torch.uint8) != q.view(torch.uint8)).sum()) \
        + int((s2.view(torch.int32) != s.view(torch.int32)).sum())
    if codes_dtype is not None:
        qb, sb = qmatmul.quantize_rows(x, fmt)
        wide = qmatmul.codes_as(qb, codes_dtype)
        codes += int((q.view(torch.uint8) != wide.view(torch.uint8)).sum())
        scales += int((s.view(torch.int32) != sb.view(torch.int32)).sum())
    ok = codes == 0 and scales == 0 and again == 0
    rows.append({"case": label, "codes_differing": codes,
                 "scales_differing": scales, "repeat_differing": again,
                 "max_abs_err": 0.0 if ok else math.inf,
                 "max_err_over_bound": 0.0 if ok else math.inf, "ok": ok})
    if not ok:
        print(f"  FAIL {label}: {codes} codes, {scales} scales differ from "
              f"plain (or the byte output), {again} from a second launch")
    return q, s


# quot_probe's dividends: exponents of a against divisors of magnitude
# [0.57, 1.15): quotients around e4m3's subnormal steps (2^-10 is half the
# least code), its normal codes, and past the clip (448)
QUOT_A_EXPS = (-11, -10, -9, -5, 0, 3, 7, 8)


def p2_divisors():
    """Every scale significand a P2 row can take: s = RN(amax / 448) with
    amax a bf16, here the 128 significands of amax in [256, 512).  Another
    exponent of amax scales s by a power of two, and quot_fast's steps with
    it while nothing underflows (the fast path's rows), so these stand for
    every scale of the fast path."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    amax = (256.0 + 2.0 * torch.arange(128, dtype=torch.float32))
    return qmatmul.div_exact(amax, 448.0)


def quot_fast_probe(rows):
    """P2's fast divide against the correctly rounded divide and its codes
    against cast.cuh's path, over every f32 significand of a at each of
    QUOT_A_EXPS against every divisor of p2_divisors (1.07e9 pairs an
    exponent).  Returns (pairs, differing quotients and codes, differing
    (a, s) pairs found)."""
    from fp8tpu_torch.kernels import qmatmul
    divs = p2_divisors().tolist()
    pairs = bad = 0
    found = []
    for e in QUOT_A_EXPS:
        q, c, f = qmatmul.quot_probe(divs, e)
        pairs += len(divs) << 23
        bad += q + c
        found += f
        rows.append({"case": f"p2 quot_fast a exponent {e}",
                     "quotients_differing": q, "codes_differing": c,
                     "max_abs_err": 0.0 if q + c == 0 else math.inf,
                     "max_err_over_bound": 0.0 if q + c == 0 else math.inf,
                     "ok": q + c == 0})
        if q + c:
            print(f"  FAIL p2 quot_fast a exponent {e}: {q} quotients, "
                  f"{c} codes differ")
    return pairs, bad, found[:16]


def w8a8_tolerance(xq, xs, w8, s, want):
    """|kernel - plain| allowed for P1: both f32 sums of exact products carry
    at most K 2^-24 of sum|x w| (summation order), times xs s; a bf16
    result may land one bf16 step away."""
    import torch
    from fp8tpu_torch._device import full_fp32
    k = xq.shape[1]
    with full_fp32():
        mag = torch.matmul(xq.float().abs(), w8.float().abs())
    scale = (xs.reshape(-1, 1) * s.reshape(1, -1)).abs()
    tol = 2.0 * k * 2.0 ** -24 * mag * scale + 1e-30
    if want.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * want.float().abs()
    return tol


# The fp8 tensor cores' sum (P1's wgmma): each k32 step aligns its 33
# addends (the running chunk and 32 exact products) to the largest one's
# exponent and keeps W8A8_TC_BITS bits below it, dropping the rest
# (w8a8_probe measures the bits), so a step's result is off by less than
# 32 units of 2^(e_max - W8A8_TC_BITS): 2^(5 - W8A8_TC_BITS) of its largest
# addend, at most that of |the chunk so far| + sum |the step's products|.
W8A8_TC_BITS = 13


def fp8_chunk_bound(xq, wq, edges):
    """The allowance for the fp8 tensor cores' own sums: over every k32 step
    of every chunk between promotion ``edges``, 2^(5 - W8A8_TC_BITS)
    (|the chunk's exact sum before the step| + sum |the step's
    products|), in f64."""
    import torch
    x, w = xq.double(), wq.double()
    bound = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float64,
                        device=x.device)
    for a, b in zip(edges, edges[1:]):
        run = torch.zeros_like(bound)
        for k0 in range(a, b, 32):
            xa, wa = x[:, k0:min(b, k0 + 32)], w[k0:min(b, k0 + 32)]
            bound += run.abs() + xa.abs() @ wa.abs()
            run += xa @ wa
    return bound * 2.0 ** (5 - W8A8_TC_BITS)


def w8a8_reference(xq, xs, w8, s, edges, out_dtype, fp8_sum=False):
    """(exact, allowed |out - exact|) for P1's output: the f64 product of the
    codes within k2_reference's random-walk bound over P1's promotion
    edges (plus, for ``fp8_sum``, the fp8 tensor cores' own sums,
    fp8_chunk_bound), then the scales' f32 products and, for bf16, the last
    rounding.  The int8 route (K3's bf16 tensor cores) keeps f32-grade
    sums: no ``fp8_sum``."""
    import torch
    exact, tol = k2_reference(xq.float(), w8.float(), edges)
    if fp8_sum:
        tol = tol + fp8_chunk_bound(xq.float(), w8.float(), edges)
    scale = xs.double().reshape(-1, 1) * s.double().reshape(1, -1)
    exact = exact * scale
    rel = 3 * 2.0 ** -24 + (2.0 ** -8 if out_dtype == torch.bfloat16 else 0)
    return exact, tol * scale.abs() + rel * exact.abs() + 1e-30


def w8a8_gemm_case(rows, label, got, again, xq, xs, w8, s, edges, cols,
                   fp8_sum=True):
    """One P1 (or, with ``fp8_sum`` False, int8 K3) launch against its
    plain version, the f64 product over its promotion edges and a second
    launch (bit for bit); the first two on the first ``cols`` columns."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    wc, sc = w8[:, :cols], s[:cols]
    want = qmatmul.w8a8_matmul_plain(xq, xs, wc, sc, got.dtype)
    tol = w8a8_tolerance(xq, xs, wc, sc, want)
    ref = w8a8_reference(xq, xs, wc, sc, edges, got.dtype, fp8_sum)
    return _gemm_case(rows, label, got[:, :cols], want, tol, None, ref) and \
        _repeat_ok(rows, got, again)


def _repeat_ok(rows, got, again):
    bad = bits_equal(again, got)
    rows[-1]["repeat_bits"] = bad
    if bad:
        rows[-1]["ok"] = False
        print(f"  FAIL {rows[-1]['case']}: a second launch differs in {bad} "
              "elements")
    return bad == 0


def w8a8_pair_codes(rows, w_dtype, m_block, label):
    """Every (activation code, weight code) pair through P1: xq (256, 32)
    holds code i in row i's first column, w8 (32, 256) code j in column
    j's first row, zeros elsewhere, unit scales; so out[i, j] is the one
    product code_i code_j, exact, NaN where either is NaN (or 0 x inf).
    Value for value against the plain version (NaN where it is NaN), in
    launches of ``m_block`` rows (64: the decode tiles, 256: prefill)."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    codes = torch.arange(256, device="cuda", dtype=torch.uint8)
    xq = torch.zeros(256, 32, device="cuda", dtype=torch.uint8)
    xq[:, 0] = codes
    xq = xq.view(torch.float8_e4m3fn)
    w8 = torch.zeros(32, 256, device="cuda", dtype=torch.uint8)
    w8[0] = codes
    w8 = w8.view(w_dtype)
    ones = torch.ones(256, device="cuda")
    got = torch.cat([qmatmul.w8a8_matmul(xq[i:i + m_block].contiguous(),
                                         ones[:m_block], w8, ones,
                                         torch.float32)
                     for i in range(0, 256, m_block)])
    want = qmatmul.w8a8_matmul_plain(xq, ones, w8, ones, torch.float32)
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    bad = int((~same).sum())
    rows.append({"case": label, "differing": bad,
                 "max_abs_err": 0.0 if not bad else math.inf,
                 "max_err_over_bound": 0.0 if not bad else math.inf,
                 "ok": bad == 0})
    if bad:
        print(f"  FAIL {label}: {bad} of 65536 pairs differ")


def k3_int8_case(rows, label, xh, xq, xs, w8, s, cols):
    """One launch of K3's int8 route (P2's f16 codes ``xh`` of the e4m3
    codes ``xq``, int8 weights) and a second, as w8a8_gemm_case holds
    them: the plain version, the f64 product over its promotion edges (the
    general kernel's own blocks where TMA cannot read the operands), a
    second launch bit for bit."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    m, k = xh.shape
    n = w8.shape[1]
    plan = qmatmul.weight_gemm_plan(m, n, k, qmatmul.sm_count(0), "w8", xh,
                                    w8)
    got = qmatmul.dequant_matmul(xh, w8, s, torch.bfloat16, xs)
    again = qmatmul.dequant_matmul(xh, w8, s, torch.bfloat16, xs)
    edges = None if plan.route == "general" else \
        qmatmul.promotion_edges(k, plan.kper)
    return w8a8_gemm_case(rows, f"{label} {plan.route} {plan.code} splits "
                          f"{plan.splits}", got, again, xq, xs, w8, s, edges,
                          cols, fp8_sum=False)


def k3_int8_pair_codes(rows, m_block):
    """Every (activation code, weight byte) pair through K3's int8 route:
    x (256, 32) holds code i's f16 value in row i's first column (as P2
    writes it: codes_as), w8 (32, 256) int8 byte j in column j's first row,
    zeros elsewhere, unit scales; out[i, j] is the one exact product, NaN
    where the code is NaN.  Value for value against the plain version, in
    launches of ``m_block`` rows (64: the decode form, 256: prefill)."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    codes = torch.arange(256, device="cuda", dtype=torch.uint8)
    xq = torch.zeros(256, 32, device="cuda", dtype=torch.uint8)
    xq[:, 0] = codes
    xq = xq.view(torch.float8_e4m3fn)
    xh = qmatmul.codes_as(xq, torch.float16)
    w8 = torch.zeros(32, 256, device="cuda", dtype=torch.uint8)
    w8[0] = codes
    w8 = w8.view(torch.int8)
    ones = torch.ones(256, device="cuda")
    got = torch.cat([qmatmul.dequant_matmul(xh[i:i + m_block].contiguous(),
                                            w8, ones, torch.float32,
                                            ones[:m_block])
                     for i in range(0, 256, m_block)])
    want = qmatmul.dequant_matmul_plain(xh, w8, ones, torch.float32, ones)
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    bad = int((~same).sum())
    rows.append({"case": f"k3 int8 route every (e4m3 code, int8 byte) pair, "
                         f"launches of {m_block} rows", "differing": bad,
                 "max_abs_err": 0.0 if not bad else math.inf,
                 "max_err_over_bound": 0.0 if not bad else math.inf,
                 "ok": bad == 0})
    if bad:
        print(f"  FAIL {rows[-1]['case']}: {bad} of 65536 pairs differ")


def tc_kept_bits_16(kind):
    """tc_kept_bits for K3's int8 route on the 16-bit tensor cores (wgmma
    k16, kind "f16": f16 codes, "bf16": bf16 x on the int8 convert): one
    product of 2^14 (256 x 64) and 15 of 2^(14 - gap) (gap 9 .. 25) in one
    k16 step, the same 15 (16) added in a second step to a chunk of 2^14,
    and 15 products of -1.5 2^(14 - gap) in one step; {gap: (kept share
    alone, into the chunk, of the negative terms)}."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    dtype = torch.float16 if kind == "f16" else torch.bfloat16
    gaps = list(range(9, 26))
    m, n = len(gaps), 16
    out = {}
    for acc, mult in ((False, 1.0), (True, 1.0), (False, -1.5)):
        k = 32
        x = torch.zeros(m, k)
        w = torch.ones(k, n, dtype=torch.int8)
        for r, gap in enumerate(gaps):
            x[r, 0] = 256.0
            x[r, 16 if acc else 1:k if acc else 16] = mult * 2.0 ** (14 - gap)
        if not acc:
            w[16:] = 0
        w[0] = 64
        xd = x.to(dtype).cuda()
        got = qmatmul.dequant_matmul(
            xd, w.cuda(), torch.ones(n, device="cuda"), torch.float32,
            torch.ones(m, device="cuda")).double().cpu()
        small = (xd.cpu().double()[:, 1:] @ w.double()[1:, :1])[:, 0]
        kept = (got[:, 0] - 2.0 ** 14) / small
        for r, gap in enumerate(gaps):
            out.setdefault(gap, []).append(float(kept[r]))
    return {g: tuple(v) for g, v in out.items()}


def w8a8_kernel_checks(record):
    """(a) P2 against plain (bytes and f16 codes) and its fast divide
    over every significand (quot_fast_probe); (b) P1 at the W8A8 shapes
    and row counts, e4m3 and e5m2 weights; (c) every code pair, P1's sums
    against cuBLASLt's; (d) K3's int8 route on P2's f16 codes (int8
    direct) at the same shapes, ragged ones, the general kernel, every
    (code, byte) pair, and the 16-bit tensor cores' kept bits."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    gen = torch.Generator(device="cuda").manual_seed(30)
    sms = qmatmul.sm_count(0)
    result, problems = {}, []

    # (a) P2
    rows = []
    for k in (4096, 1001):
        x = p2_edge_rows(k).cuda()
        p2_case(rows, f"p2 edge rows K={k}", x)
        p2_case(rows, f"p2 edge rows K={k} e5m2", x, "e5m2")
        p2_case(rows, f"p2 edge rows K={k} f16 codes", x,
                codes_dtype=torch.float16)
        tiny = qmatmul.quantize_rows_plain(x[6:7].cpu())
    for m in P2_MS:
        for k in P2_KS:
            x = (torch.randn(m, k, device="cuda", generator=gen)
                 * torch.rand(m, 1, device="cuda", generator=gen) * 8
                 ).to(torch.bfloat16)
            p2_case(rows, f"p2 M={m} K={k}", x)
            p2_case(rows, f"p2 M={m} K={k} f16 codes", x,
                    codes_dtype=torch.float16)
    result["p2"] = rows
    print(f"w8a8 (a) P2: {len(rows)} cases (edge rows: zero, bf16 "
          f"subnormals, +-bf16 max and -0, +-inf, NaN, tiny amax, ties; "
          f"random rows at M in {P2_MS} x K in {P2_KS}; e4m3 bytes and f16 "
          f"codes), codes and scales against plain on the CPU, f16 codes "
          f"against the byte output on the card, and a second launch "
          f"bit for bit: {sum(not r['ok'] for r in rows)} failed; the "
          f"tiny-amax row's scale {float(tiny[1]):.6e} (kept subnormal), "
          f"codes {tiny[0].view(torch.uint8)[0, :4].tolist()}")
    if not all(r["ok"] for r in rows):
        problems.append("P2 differs from its plain version")
    probe_rows = []
    pairs, bad, found = quot_fast_probe(probe_rows)
    result["p2_quot_probe"] = {"rows": probe_rows, "pairs": pairs,
                               "found": found}
    print(f"w8a8 (a) P2's fast divide (quot_fast, two corrections) over "
          f"every f32 significand of a at exponents {QUOT_A_EXPS} against "
          f"every scale significand a row can take (128): {pairs} pairs, "
          f"{bad} differing quotients and codes against the correctly "
          f"rounded divide and cast.cuh's path (0 required)"
          + (f"; first pairs (a, s bits) "
             f"{[(hex(a), hex(s)) for a, s in found[:4]]}" if found else ""))
    if bad:
        problems.append(f"P2's fast divide differs in {bad} quotients or "
                        "codes")

    # (b) P1 and (d) K3 with a row scale
    rows, rows3 = [], []
    qmatmul.reset_launches()
    for k, n in W8A8_KN:
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        w[:, 0] = 0.0                                   # an all-zero column
        payloads = {f: tuple(t.reshape(-1) if i else t for i, t in enumerate(
            qmatmul.quantize_weights(w, f))) for f in ("e4m3", "e5m2", "int8")}
        del w
        for m in W8A8_MS:
            x = torch.randn(m, k, device="cuda", generator=gen
                            ).to(torch.bfloat16)
            xq, xs = qmatmul.quantize_rows(x)
            xs = xs.reshape(-1)
            cols = n if m < W8A8_SLICE_M else min(n, W8A8_COLS)
            p1plan = qmatmul.w8a8_plan(m, n, k, sms)
            edges = qmatmul.w8a8_edges(k, p1plan.kper)
            for fmt in ("e4m3", "e5m2"):
                w8, s = payloads[fmt]
                dtypes = (torch.bfloat16, torch.float32) if m in (8, 2048) \
                    else (torch.bfloat16,)
                for out_dtype in dtypes:
                    got = qmatmul.w8a8_matmul(xq, xs, w8, s, out_dtype)
                    again = qmatmul.w8a8_matmul(xq, xs, w8, s, out_dtype)
                    w8a8_gemm_case(
                        rows, f"p1 {fmt} M={m} K={k} N={n} "
                        f"{str(out_dtype)[6:]} {p1plan.route} "
                        f"{p1plan.code} splits {p1plan.splits}",
                        got, again, xq, xs, w8, s, edges, cols)
            w8, s = payloads["int8"]
            xh, _ = qmatmul.quantize_rows(x, codes_dtype=torch.float16)
            k3_int8_case(rows3, f"k3 int8 route M={m} K={k} N={n}", xh, xq,
                         xs, w8, s, cols)
        del payloads
    # one-sign terms over the long K of the down projection: where the
    # tensor cores' truncation adds up (w8a8_probe measures it)
    k, n, m = 11008, 4096, 64
    xq, w8 = probe_operands(gen, m, k, n)
    xs = torch.rand(m, device="cuda", generator=gen) + 0.5
    s = torch.rand(n, device="cuda", generator=gen) + 0.5
    kper = qmatmul.w8a8_plan(m, n, k, sms).kper
    for out_dtype in (torch.float32, torch.bfloat16):
        got = qmatmul.w8a8_matmul(xq, xs, w8, s, out_dtype)
        again = qmatmul.w8a8_matmul(xq, xs, w8, s, out_dtype)
        w8a8_gemm_case(rows, f"p1 one-sign M={m} K={k} N={n} "
                       f"{str(out_dtype)[6:]}", got, again, xq, xs, w8, s,
                       qmatmul.w8a8_edges(k, kper), n)
    for m, k, n in W8A8_RAGGED + W8A8_GENERAL:
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
        xq, xs = qmatmul.quantize_rows(x)
        xs = xs.reshape(-1)
        w8, s = qmatmul.quantize_weights(w, "int8")
        xh, _ = qmatmul.quantize_rows(x, codes_dtype=torch.float16)
        k3_int8_case(rows3, f"k3 int8 route ragged M={m} K={k} N={n}", xh,
                     xq, xs, w8, s.reshape(-1), n)
        if k % 32:
            continue                    # P1 takes K % 32 == 0 only
        p1plan = qmatmul.w8a8_plan(m, n, k, sms)
        edges = qmatmul.w8a8_edges(k, p1plan.kper)
        for fmt in ("e4m3", "e5m2"):
            w8, s = qmatmul.quantize_weights(w, fmt)
            s = s.reshape(-1)
            for out_dtype in (torch.bfloat16, torch.float32):
                got = qmatmul.w8a8_matmul(xq, xs, w8, s, out_dtype)
                again = qmatmul.w8a8_matmul(xq, xs, w8, s, out_dtype)
                w8a8_gemm_case(
                    rows, f"p1 ragged N {fmt} M={m} K={k} N={n} "
                    f"{str(out_dtype)[6:]} {p1plan.route}", got, again, xq,
                    xs, w8, s, edges, n)
    p1_launches = qmatmul.w8a8_launches
    vendor = []
    vendor_sums(vendor, gen)
    print(f"w8a8 (c) P1's f32 sums against cuBLASLt's fp8 GEMM "
          f"(torch._scaled_mm, a yardstick) at {len(vendor)} shapes: "
          f"{sum(r['differing'] for r in vendor)} of "
          f"{sum(r['elements'] for r in vendor)} differ")
    result["p1_vendor_sums"] = vendor
    if not all(r["ok"] for r in vendor):
        problems.append("P1's f32 sums differ from cuBLASLt's fp8 GEMM")
    for w_dtype, fmt in ((torch.float8_e4m3fn, "e4m3"),
                         (torch.float8_e5m2, "e5m2")):
        for mb in (64, 256):
            w8a8_pair_codes(rows, w_dtype, mb, f"p1 every e4m3 x {fmt} code "
                            f"pair, launches of {mb} rows")
    for mb in (64, 256):
        k3_int8_pair_codes(rows3, mb)
    kept = {kind: tc_kept_bits_16(kind) for kind in ("f16", "bf16")}
    bits16 = {}
    for kind, kk in kept.items():
        whole = [g for g, v in kk.items() if min(v[:2]) == 1.0]
        bits16[kind] = max(whole) if whole else 0
        print(f"w8a8 (d) the {kind} tensor cores' k16 sum (tc_kept_bits_16"
              f"): terms within {bits16[kind]} bits of the largest addend "
              f"kept whole; share kept by gap (alone, into a chunk, "
              f"negative): " + ", ".join(
                  f"{g}: ({v[0]:.3f}, {v[1]:.3f}, {v[2]:.3f})"
                  for g, v in kk.items() if g >= 20))
    result["k3_int8_kept_bits"] = {"bits": bits16, "shares": kept}
    if bits16["f16"] < bits16["bf16"]:
        problems.append(f"the f16 tensor cores keep {bits16['f16']} bits, "
                        f"fewer than bf16's {bits16['bf16']}: the int8 "
                        "route's promotion must follow")
    torch.cuda.synchronize()
    result["p1"], result["k3_row_scale"] = rows, rows3
    for name, rs in (("P1", rows), ("K3's int8 route (f16 codes)", rows3)):
        worst = max(r["max_err_over_bound"] for r in rs)
        f64 = max(r.get("err_over_f64_bound", 0.0) for r in rs)
        print(f"w8a8 ({'b' if name == 'P1' else 'd'}) {name}: {len(rs)} "
              f"cases (M in {W8A8_MS} x (K, N) in {W8A8_KN}"
              f"{', e4m3 / e5m2 weights, one-sign K = 11008, ragged N, every code pair' if name == 'P1' else ', ragged N, the general kernel, every (code, byte) pair'}; "
              f"M >= {W8A8_SLICE_M} held on the first {W8A8_COLS} columns): "
              f"worst err/bound {worst:.3e}, worst err/f64 bound {f64:.3e}; "
              f"{sum(not r['ok'] for r in rs)} failed")
        if not all(r["ok"] for r in rs):
            problems.append(f"{name} disagrees with its plain version, the "
                            "f64 product or a second launch")
    print(f"w8a8: P1 launches {p1_launches}, K3 row-scaled launches by route "
          f"{dict(qmatmul.dequant_routes)}")
    if qmatmul.dequant_launches != 2 * len(W8A8_KN) * len(W8A8_MS) \
            + 2 * len(W8A8_RAGGED + W8A8_GENERAL) + 256 // 64 + 256 // 256 \
            + 2 * 3:
        problems.append("dequant_matmul did not count its row-scaled "
                        "launches")
    record["w8a8_kernels"] = result
    if problems:
        raise PhaseError("; ".join(problems))


def probe_operands(gen, m, k, n):
    """Positive e4m3 codes of log-uniform magnitude (2^-6 to 2^8): products
    of 2^-12 to 2^16 whose f32 sums over K lose bits in every order, so a
    sum the tensor cores keep in fewer bits than f32 shows against the
    random-walk bound (codes of one binade would sum exactly)."""
    import torch

    def codes(rows, cols):
        e = torch.rand(rows, cols, device="cuda", generator=gen) * 14 - 6
        return torch.exp2(e).to(torch.float8_e4m3fn)
    return codes(m, k), codes(k, n)


def tc_kept_bits():
    """How many bits below the largest addend a k32 fp8 wgmma keeps: one
    product of 2^16 and 31 of 2^(16 - gap) (gap 9 .. 25) in one step, the
    same 31 (32) products added in a second step to a chunk of 2^16, and
    31 products of -1.5 2^(16 - gap) in one step (which way the dropped
    bits go); {gap: (kept share alone, into the chunk, of the negative
    terms)}, a share 1.0 where the small terms survive whole, 0.0 where
    they vanish."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    gaps = list(range(9, 26))
    m, n = len(gaps), 16
    out = {}
    for acc, mult in ((False, 1.0), (True, 1.0), (False, -1.5)):
        k = 64 if acc else 32
        x = torch.zeros(m, k)
        w = torch.ones(k, n)
        for r, gap in enumerate(gaps):
            x[r, 0] = 256.0
            x[r, 32 if acc else 1:k] = mult * 2.0 ** (16 - gap)
        w[0] = 256.0
        xq = x.to(torch.float8_e4m3fn).cuda()
        w8 = w.to(torch.float8_e4m3fn).cuda()
        got = qmatmul.w8a8_matmul(xq, torch.ones(m, device="cuda"), w8,
                                  torch.ones(n, device="cuda"),
                                  torch.float32).double().cpu()
        small = (xq.cpu().double()[:, 1:] @ w8.cpu().double()[1:, :1])[:, 0]
        kept = (got[:, 0] - 2.0 ** 16) / small
        for r, gap in enumerate(gaps):
            out.setdefault(gap, []).append(float(kept[r]))
    return {g: tuple(v) for g, v in out.items()}


def phase_w8a8_probe(record):
    """P1's product over K = 11008 of terms of one sign (probe_operands) at
    several tensor-core chunk lengths, unsplit (M = 2048, N = 4096: 512
    tiles): the measurement behind W8A8_PROMOTE; the bits the fp8
    tensor cores keep (tc_kept_bits), the measurement behind
    W8A8_TC_BITS; and K3's int8 route's one-sign sum over the same K on
    the f16 and the bf16 tensor cores (k3_int8_sum_probe)."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    kept = tc_kept_bits()
    whole = [g for g, v in kept.items() if min(v[:2]) == 1.0]
    bits = max(whole) if whole else 0
    for g, (alone, into, neg) in kept.items():
        print(f"w8a8_probe kept bits: 31 products 2^-{g} of the largest "
              f"addend: share kept {alone:.4f} in one step, {into:.4f} "
              f"added to a chunk; of -1.5 2^-{g} each {neg:.4f}")
    print(f"w8a8_probe: the fp8 tensor cores keep whole every term within "
          f"{bits} bits of the largest addend (bound assumes "
          f"{W8A8_TC_BITS})")
    gen = torch.Generator(device="cuda").manual_seed(31)
    m, k, n = 2048, 11008, 4096
    xq, w8 = probe_operands(gen, m, k, n)
    ones_m = torch.ones(m, device="cuda")
    ones_n = torch.ones(n, device="cuda")
    plan = qmatmul.w8a8_plan(m, n, k, qmatmul.sm_count(0))
    kper = plan.kper
    if plan.splits != 1:
        raise PhaseError(f"the probe's shape splits K ({plan.splits})")
    cols = 512
    rows = []
    for promote in W8A8_PROBE:
        got = qmatmul.w8a8_matmul(xq, ones_m, w8, ones_n, torch.float32,
                                  promote=promote)[:, :cols]
        edges = qmatmul.w8a8_edges(k, kper, promote)
        ex, tol = k2_reference(xq.float(), w8[:, :cols].float(), edges)
        tc = fp8_chunk_bound(xq.float(), w8[:, :cols].float(), edges)
        rel = (got.double() - ex) / ex
        rows.append({"promote_steps": promote, "chunk": 32 * promote,
                     "err_over_tol": k2_ratio(got, ex, tol + tc),
                     "err_over_f32_walk": k2_ratio(got, ex, tol),
                     "mean_rel_err": float(rel.mean()),
                     "max_abs_rel_err": float(rel.abs().max())})
        print(f"w8a8_probe chunk {32 * promote} (M={m} K={k} N={n}, first "
              f"{cols} columns, positive codes 2^-6..2^8): |err| / "
              f"tolerance {rows[-1]['err_over_tol']:.3e} (over the f32 "
              f"walk alone {rows[-1]['err_over_f32_walk']:.3e}), mean "
              f"relative error {rows[-1]['mean_rel_err']:.3e}, max "
              f"|relative error| {rows[-1]['max_abs_rel_err']:.3e}")
        del ex, tol, tc
    record["w8a8_probe"] = {"rows": rows, "kept": kept, "kept_bits": bits,
                            "w8a8_tc_bits": W8A8_TC_BITS,
                            "w8a8_promote": qmatmul.W8A8_PROMOTE,
                            "k3_int8": k3_int8_sum_probe(gen)}
    used = [r for r in rows if r["promote_steps"] == qmatmul.W8A8_PROMOTE]
    if not used or used[0]["err_over_tol"] > 1.0:
        raise PhaseError("P1's chunk length does not keep the long sum "
                         "within the tolerance")
    if bits < W8A8_TC_BITS:
        raise PhaseError(f"the fp8 tensor cores keep {bits} bits, fewer "
                         f"than the bound's {W8A8_TC_BITS}")


def k3_int8_sum_probe(gen, m=2048, k=11008, n=4096, cols=512):
    """K3's int8 route over K = 11008 of terms of one sign, on the f16
    tensor cores (P2's f16 codes) beside the bf16 ones (the same codes as
    bf16 x, K3's bf16 int8 convert): positive e4m3 codes of log-uniform
    magnitude against int8 bytes 1-127, unit scales, f32 out, held to the
    f64 product's random-walk bound over the promotion edges (512 rows).
    Returns {kind: (err / bound, mean relative error, max |relative
    error|)}."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    xq, _ = probe_operands(gen, m, k, 1)
    w8 = torch.randint(1, 128, (k, n), device="cuda", generator=gen,
                       dtype=torch.int8)
    ones_m = torch.ones(m, device="cuda")
    ones_n = torch.ones(n, device="cuda")
    plan = qmatmul.weight_gemm_plan(m, n, k, qmatmul.sm_count(0), "w8",
                                    xq, w8)
    edges = qmatmul.promotion_edges(k, plan.kper)
    ex, tol = k2_reference(xq.float(), w8[:, :cols].float(), edges)
    out = {}
    for kind, dtype in (("f16", torch.float16), ("bf16", torch.bfloat16)):
        got = qmatmul.dequant_matmul(xq.to(dtype), w8, ones_n,
                                     torch.float32, ones_m)[:, :cols]
        rel = (got.double() - ex) / ex
        out[kind] = (k2_ratio(got, ex, tol), float(rel.mean()),
                     float(rel.abs().max()))
        print(f"w8a8_probe K3's int8 route on {kind} (M={m} K={k} N={n}, "
              f"first {cols} columns, positive codes x bytes 1-127, "
              f"promoted every {qmatmul.STREAM_PROMOTE} rows): |err| / "
              f"f32 walk {out[kind][0]:.3e}, mean relative error "
              f"{out[kind][1]:.3e}, max |relative error| "
              f"{out[kind][2]:.3e}", flush=True)
    return out


W8A8_TIME_MS = (8, 64, 512, 2048)


def w8a8_ring_state(prm, scfg, slots=None):
    """A ring of ``slots`` (default BENCH_BATCH) slots after a prefill of
    random prompts of 8-32 tokens (seed 33): (ring, next tokens,
    positions), the state of the w8a8 phase's ring decode steps."""
    import torch
    from fp8tpu_torch.serve import RingKVCache, prefill_batch
    cfg = scfg.model
    slots = slots or BENCH_BATCH
    g = torch.Generator(device="cuda").manual_seed(33)
    ring = RingKVCache.create(cfg.n_layers, slots, SERVE_SEQ,
                              cfg.n_kv_heads, cfg.head_dim, "int8")
    prompts = torch.randint(1, cfg.vocab_size, (slots, 32), device="cuda",
                            generator=g, dtype=torch.int32)
    lengths = torch.randint(8, 33, (slots,), device="cuda", generator=g,
                            dtype=torch.int32)
    zi = torch.zeros(slots, device="cuda", dtype=torch.int32)
    _, ring, toks, pos = prefill_batch(
        prm, ring, prompts, torch.arange(slots, device="cuda",
                                         dtype=torch.int32), lengths,
        None, torch.zeros(slots, device="cuda"), None, None, zi,
        zi.clone(), scfg)
    return ring, toks, pos


def clone_ring(r):
    from fp8tpu_torch.serve import RingKVCache
    return RingKVCache(r.kv8.clone(), r.sc.clone(), r.head.clone())


def w8a8_pool_state(prm, scfg):
    """A paged pool of BENCH_BATCH slots of 4 pages (a random page table)
    after a prefill of random prompts of 70-128 tokens (seed 34)."""
    import torch
    from fp8tpu_torch.serve import PagedKVCache, prefill_batch_paged
    cfg = scfg.model
    B = BENCH_BATCH
    g = torch.Generator(device="cuda").manual_seed(34)
    paged = PagedKVCache.create(B * 4, PAGE, cfg.n_layers, B, 4,
                                cfg.n_kv_heads, cfg.head_dim, "int8")
    paged.page_table = torch.randperm(
        B * 4, device="cuda", generator=g).to(torch.int32).reshape(B, 4)
    prompts = torch.randint(1, cfg.vocab_size, (B, 128), device="cuda",
                            generator=g, dtype=torch.int32)
    lengths = torch.randint(70, 129, (B,), device="cuda", generator=g,
                            dtype=torch.int32)
    zi = torch.zeros(B, device="cuda", dtype=torch.int32)
    _, paged, toks, pos = prefill_batch_paged(
        prm, paged, prompts, torch.arange(B, device="cuda",
                                          dtype=torch.int32), lengths,
        None, torch.zeros(B, device="cuda"), None, None, zi, zi.clone(),
        scfg)
    return paged, toks, pos


def phase_w8a8(record):
    """W8A8 serving (matmul_impl="direct") at full width: (a)-(d) the
    kernels (w8a8_kernel_checks); (e) decode steps at batch 64 on the ring
    and the paged pool in "kernel" mode, e4m3 and int8 weights, int8 KV,
    direct against the plain versions: one step with every layer started
    from the plain run's input to it (forced_step), every layer held; 4
    free-running steps, their launches held on their own operands; and one
    MoE step with routing flips counted; (f) 16 requests through the
    EngineServer, every token equal to a replay of its admission in the
    engine's own order (replay_engine).  Returns the main path's launches
    (f)."""
    import dataclasses
    import torch
    from fp8tpu_torch.kernels import inplace, qmatmul
    from fp8tpu_torch.kernels import paged_attention as k4
    from fp8tpu_torch.serve import (ServeConfig, decode_step,
                                    decode_step_paged, random_serve_params)
    from fp8tpu_torch.serve import engine as engine_mod

    w8a8_kernel_checks(record)
    cfg = serve_config()
    L, KV = cfg.n_layers, cfg.n_kv_heads
    B = BENCH_BATCH
    result, problems = {}, []
    params = {fmt: serve_params_of(fmt) for fmt in ("e4m3", "int8")}

    # (e) decode steps, direct against plain.  W8A8 is discontinuous: two
    # f32 summation orders of one model drift apart from layer to layer
    # (trap 49), so each layer is held from a common input (forced_step),
    # the kernels launch by launch along the path, and the free-running
    # steps' logits to the drift of a second plain order (exact sums,
    # with_exact_plain) from the plain one.
    result["e"] = {}
    for fmt in ("e4m3", "int8"):
        prm = params[fmt]
        scfg = ServeConfig(model=cfg, weight_fmt=fmt, kv_fmt="int8",
                           matmul_impl="direct")
        kcfg = dataclasses.replace(scfg, paged_decode_impl="kernel")
        for name, step, make, clone in (
                ("ring", lambda st, t, p, prm=prm, c=scfg: decode_step(
                    prm, st, t, p, c), lambda: w8a8_ring_state(prm, scfg),
                 clone_ring),
                ("paged kernel", lambda st, t, p, prm=prm, c=kcfg:
                 decode_step_paged(prm, st, t, p, c),
                 lambda: w8a8_pool_state(prm, kcfg), clone_pool)):
            state = make()
            h0 = int(state[0].head) if name == "ring" else None
            k4_checks = []
            reference = with_plain_kernels if name == "ring" \
                else with_plain_but_k4
            f_err, f_dist = forced_step(step, state, clone, KV, h0,
                                        k4_checks, reference)
            layer_tol, ctrl = SERVE_LOGIT_TOL, None
            if fmt == "e4m3":
                # the control: cuBLASLt's fp8 GEMM in P1's place, held to
                # nothing, against the same f32 plain reference
                layer_tol = W8A8_FP8_LAYER_TOL
                orig = qmatmul.w8a8_matmul
                qmatmul.w8a8_matmul = scaled_mm_p1
                try:
                    ctrl, _ = forced_step(step, state, clone, KV, h0, [],
                                          reference)
                finally:
                    qmatmul.w8a8_matmul = orig
            f_bad = [i for i, (e, d) in enumerate(zip(f_err, f_dist))
                     if not (e <= layer_tol
                             and d["equal"] >= SERVE_RING_EQUAL
                             and d["deq"] <= SERVE_LOGIT_TOL)]
            k4_bad = [c for c in k4_checks if not c["ok"]]
            ctrl_txt = "" if ctrl is None else \
                "; cuBLASLt's fp8 GEMM in P1's place [" + ", ".join(
                    f"{e:.2e}" for e in ctrl) + "]"
            print(f"w8a8 (e) {fmt} weights, {name}: one step with every layer "
                  f"started from the plain run's input to it"
                  f"{'' if name == 'ring' else ' (K4 kernel in both)'}: "
                  f"layer outputs "
                  f"max|diff| / max|out| [{', '.join(f'{e:.2e}' for e in f_err)}]"
                  f" (at most {layer_tol}{ctrl_txt}); the rows it wrote, by "
                  f"layer: {fmt_layers(f_dist)} (each layer at least "
                  f"{SERVE_RING_EQUAL} equal); K4 launches against plain "
                  f"{len(k4_checks) - len(k4_bad)} of {len(k4_checks)} "
                  f"within k4_reference's bounds, worst |acc diff| / bound "
                  f"{max((c['err_over_bound'] for c in k4_checks), default=0.0):.3f}")
            if f_bad or len(f_err) != L or k4_bad or \
                    len(k4_checks) != (L if name != "ring" else 0):
                problems.append(f"direct {fmt} {name}, layers forced: layers "
                                f"off {f_bad} of {len(f_err)}, K4 launches "
                                f"{len(k4_checks)}, off {len(k4_bad)}")
            qmatmul.reset_launches()
            k4.reset_launches()
            inplace.reset_launches()
            rows = []
            d_k, d_x, st_k, st_p, st_x, pos0 = direct_steps(
                step, state, clone, W8A8_STEPS, rows)
            per_step = tuple(c / W8A8_STEPS for c in (
                qmatmul.quantize_launches, qmatmul.w8a8_launches,
                qmatmul.dequant_launches, k4.launches, inplace.launches))
            live = torch.ones(W8A8_STEPS, B, dtype=torch.bool, device="cuda")
            same, dist, _ = cache_checks(f"direct {fmt} {name}", st_k, st_p,
                                         pos0, W8A8_STEPS, KV, live, h0,
                                         whole_gate=False)
            same_x, dist_x, _ = cache_checks(f"exact {fmt} {name}", st_x,
                                             st_p, pos0, W8A8_STEPS, KV,
                                             live, h0, whole_gate=False)
            want = (7 * L, 7 * L if fmt == "e4m3" else 0,
                    0 if fmt == "e4m3" else 7 * L,
                    L if name != "ring" else 0, 1 if name == "ring" else 0)
            worst = max(r["max_err_over_bound"] for r in rows)
            f64 = max(r.get("err_over_f64_bound", 0.0) for r in rows)
            print(f"w8a8 (e) {fmt} weights, {name}: {W8A8_STEPS} decode steps "
                  f"at batch {B}: the first step's {len(rows)} P2 / P1 / K3 "
                  f"launches on their own operands: worst err/bound "
                  f"{worst:.3e}, err/f64 bound {f64:.3e}, "
                  f"{sum(not r['ok'] for r in rows)} failed; max|logit diff| "
                  f"/ max|logit|: kernels vs plain {d_k:.3e}, exact-sum plain "
                  f"vs plain {d_x:.3e} (kernels held to 3x that, or "
                  f"{SERVE_LOGIT_TOL}); cache bytes equal {same:.4f} (exact "
                  f"{same_x:.4f}); the rows the steps wrote, by layer, "
                  f"kernels vs plain: {fmt_layers(dist)}; exact vs plain: "
                  f"{fmt_layers(dist_x)}; a step P2 / P1 / K3 / K4 / K6 "
                  f"{per_step} (expected {want})")
            if not all(r["ok"] for r in rows):
                problems.append(f"direct {fmt} {name}: a launch of the step "
                                "is outside its bounds")
            if not d_k <= max(3 * d_x, SERVE_LOGIT_TOL) or \
                    dist[0]["equal"] < SERVE_RING_EQUAL:
                problems.append(f"direct {fmt} {name}: logits {d_k} against "
                                f"the orders' drift {d_x}, layer 0 rows "
                                f"equal {dist[0]['equal']}")
            if per_step != want:
                problems.append(f"direct {fmt} {name}: launches a step "
                                f"{per_step}, expected {want}")
            result["e"][f"{fmt} {name}"] = {
                "forced_layer_rel_err": f_err, "forced_layer_tol": layer_tol,
                "forced_control_cublaslt": ctrl,
                "forced_written_rows_by_layer": f_dist,
                "forced_k4_launches": k4_checks,
                "launch_rows": rows, "max_rel_logit_diff": d_k,
                "exact_order_drift": d_x, "cache_bytes_equal": same,
                "written_rows_by_layer": dist,
                "exact_written_rows_by_layer": dist_x,
                "launches_per_step": per_step}
            del state, st_k, st_p, st_x

    # one MoE decode step with direct linears: each expert quantizes its
    # own input
    mcfg = moe_config()
    mparams = STATE.get("moe") or random_serve_params(mcfg, "e4m3", seed=20)
    mscfg = ServeConfig(model=mcfg, weight_fmt="e4m3", kv_fmt="int8",
                        matmul_impl="direct")
    mstate = w8a8_ring_state(mparams, mscfg, SERVE_SLOTS)
    qmatmul.reset_launches()
    worst, flips, st_k, st_p, live, pos0 = moe_steps_vs_plain(
        lambda st, t, p: decode_step(mparams, st, t, p, mscfg), mstate,
        clone_ring, 1)
    off_tie = {t: f for t, f in flips.items() if not f[2]}
    per = mcfg.n_layers * (4 + 2 * mcfg.n_experts)
    print(f"w8a8 (e) MoE, one decode step at {SERVE_SLOTS} slots, direct vs "
          f"plain: {worst:.3e} of max|logit|, routing flips (slot: step, "
          f"layer, near tie) {flips or 'none'}; P2 / P1 launches "
          f"{qmatmul.quantize_launches} / {qmatmul.w8a8_launches} (expected "
          f"{per} each)")
    if worst > SERVE_LOGIT_TOL or off_tie or qmatmul.w8a8_launches != per:
        problems.append(f"direct MoE step: logits {worst}, flips off a near "
                        f"tie {off_tie}, P1 launches {qmatmul.w8a8_launches}")
    result["e"]["moe"] = {"max_rel_logit_diff": worst, "routing_flips": flips}
    del st_k, st_p, mparams, mstate

    # (f) the served main path with direct linears, twice (the kernels are
    # deterministic), every token held to the teacher-forced band
    scfg = ServeConfig(model=cfg, weight_fmt="e4m3", kv_fmt="int8",
                       matmul_impl="direct")
    prompts = {r.uid: r.prompt for r in serve_requests(7, 16, cfg.vocab_size)}
    qmatmul.reset_launches()
    inplace.reset_launches()
    with _Counting(engine_mod, "decode_chunk", steps_arg=6) as dc, \
            _Counting(engine_mod, "prefill_batch") as pb, \
            _Admissions(engine_mod) as adm, \
            _Counting(qmatmul, "w8a8_matmul_plain", forbid=True), \
            _Counting(qmatmul, "quantize_rows_plain", forbid=True), \
            _Counting(qmatmul, "dequant_matmul_plain", forbid=True), \
            _Counting(inplace, "ring_store_plain", forbid=True):
        out, seconds, _ = run_server(params["e4m3"], scfg, 16)
    launches = {"quantize_rows": qmatmul.quantize_launches,
                "w8a8_matmul": qmatmul.w8a8_routes["decode"],
                "w8a8_matmul_prefill": qmatmul.w8a8_routes["prefill"]}
    p1_step = (qmatmul.w8a8_launches - 7 * L * pb.calls) / dc.steps
    again, _, _ = run_server(params["e4m3"], scfg, 16)
    bad, steps = replay_engine(params["e4m3"], scfg, adm.calls, prompts, out)
    n_tok = sum(len(v) for v in out.values())
    print(f"w8a8 (f): 16 requests x {SERVE_NEW} tokens through EngineServer "
          f"with direct linears ({SERVE_SLOTS} slots): {n_tok} tokens in "
          f"{seconds:.2f} s; {dc.steps} decode steps, {pb.calls} prefills; "
          f"launches {launches}, P1 {p1_step:.1f} a decode step (expected "
          f"{7 * L}); a second run's tokens equal: {again == out}; the "
          f"replay of each admission in the engine's order: {steps} tokens "
          f"compared, tokens that differ {bad or 'none'}")
    if bad or steps != n_tok or again != out or len(out) != 16 or any(
            len(v) != SERVE_NEW for v in out.values()):
        problems.append(f"direct engine: tokens unlike the replay's {bad} "
                        f"({steps} of {n_tok} compared), second run equal "
                        f"{again == out}")
    if p1_step != 7 * L or qmatmul.dequant_launches:
        problems.append(f"direct engine: P1 {p1_step} a step, K3 "
                        f"{qmatmul.dequant_launches}")
    result["f"] = {"tokens": n_tok, "seconds": seconds, "launches": launches,
                   "repeat_equal": again == out, "replayed_tokens": steps,
                   "unlike_replay": {str(k): v for k, v in bad.items()}}

    # (f) with int8 weights: K3's int8 route on P2's f16 codes, every
    # token against the replay
    scfg8 = dataclasses.replace(scfg, weight_fmt="int8")
    qmatmul.reset_launches()
    with _Counting(engine_mod, "decode_chunk", steps_arg=6) as dc, \
            _Counting(engine_mod, "prefill_batch") as pb, \
            _Admissions(engine_mod) as adm, \
            _Counting(qmatmul, "quantize_rows_plain", forbid=True), \
            _Counting(qmatmul, "dequant_matmul_plain", forbid=True), \
            _Counting(inplace, "ring_store_plain", forbid=True):
        out8, seconds8, _ = run_server(params["int8"], scfg8, 16)
    launches["dequant_matmul_int8"] = qmatmul.dequant_routes["stream"]
    launches["dequant_matmul_int8_prefill"] = qmatmul.dequant_routes["prefill"]
    routes8 = dict(qmatmul.dequant_routes)
    counts8 = (qmatmul.quantize_launches, qmatmul.w8a8_launches)
    k3_step = (qmatmul.dequant_launches - 7 * L * pb.calls) / dc.steps
    f16_codes = qmatmul.quantize_launches == qmatmul.dequant_launches
    bad8, steps8 = replay_engine(params["int8"], scfg8, adm.calls, prompts,
                                 out8)
    n_tok8 = sum(len(v) for v in out8.values())
    print(f"w8a8 (f) int8 weights: {n_tok8} tokens in {seconds8:.2f} s; "
          f"{dc.steps} decode steps, {pb.calls} prefills; K3 int8 route "
          f"launches by route {routes8}, {k3_step:.1f} a decode step "
          f"(expected {7 * L}), P2 / P1 {counts8}; the replay: {steps8} "
          f"tokens compared, tokens that differ {bad8 or 'none'}")
    if bad8 or steps8 != n_tok8 or len(out8) != 16:
        problems.append(f"direct int8 engine: tokens unlike the replay's "
                        f"{bad8} ({steps8} of {n_tok8} compared)")
    if k3_step != 7 * L or counts8[1] or not f16_codes:
        problems.append(f"direct int8 engine: K3 {k3_step} a step, P2 / P1 "
                        f"{counts8} against K3 {routes8}")
    result["f_int8"] = {"tokens": n_tok8, "seconds": seconds8,
                        "replayed_tokens": steps8,
                        "unlike_replay": {str(k): v for k, v in bad8.items()}}
    record["w8a8"] = result
    torch.cuda.empty_cache()
    if problems:
        raise PhaseError("; ".join(problems))
    return launches


def w8a8_plain_exact(xq, xs, w8, s, out_dtype=None):
    """P1's function with the exact sum: the codes' products and sums in
    f64 (exact: a product of two e4m3 / e5m2 codes spans 2^-34 to 2^32,
    so K <= 2^16 terms fit f64's 53 bits), rounded once to f32; then
    ``acc * (xs * s)`` as the plain version.  A second summation order of
    the same model."""
    import torch
    acc = (xq.double() @ w8.double()).float()
    scale = xs.reshape(-1, 1).float() * s.reshape(1, -1).float()
    return (acc * scale).to(out_dtype or torch.bfloat16)


def dequant_plain_exact(x, w8, scales, out_dtype=None, row_scale=None):
    """K3's function (with its row scale) on exact f64 sums, as above."""
    import torch
    acc = (x.to(torch.bfloat16).double() @ w8.double()).float()
    s = scales.reshape(1, -1).float()
    if row_scale is not None:
        s = row_scale.reshape(-1, 1).float() * s
    return (acc * s).to(out_dtype or torch.bfloat16)


def with_exact_plain(fn):
    """``fn()`` with the plain versions, P1's and K3's summing exactly."""
    from fp8tpu_torch.kernels import qmatmul
    orig = (qmatmul.w8a8_matmul_plain, qmatmul.dequant_matmul_plain)
    qmatmul.w8a8_matmul_plain = w8a8_plain_exact
    qmatmul.dequant_matmul_plain = dequant_plain_exact
    try:
        return with_plain_kernels(fn)
    finally:
        qmatmul.w8a8_matmul_plain, qmatmul.dequant_matmul_plain = orig


class _ForcedLayers:
    """While the context is open, every ``_ffn_block`` call of the serving
    model (one a layer, where the layer's output is made) keeps that
    output; given ``outs``, another run's outputs in call order, it hands
    those on instead, so each layer of this run starts from the other
    run's input to it and no layer's difference reaches the next."""

    def __init__(self, outs=None):
        from fp8tpu_torch.serve import model as smodel
        self.smodel, self.given, self.outs = smodel, outs, []

    def __enter__(self):
        self.orig = self.smodel._ffn_block

        def shim(h, xs, mcfg, linear, tp=None):
            out = self.orig(h, xs, mcfg, linear, tp)
            self.outs.append(out.clone())
            return out if self.given is None else \
                self.given[len(self.outs) - 1]

        self.smodel._ffn_block = shim
        return self

    def __exit__(self, *exc):
        self.smodel._ffn_block = self.orig


def forced_step(step, state, clone, kv_heads, h0, k4_checks,
                reference=with_plain_kernels):
    """One decode step of ``step(state, toks, pos)`` under ``reference``
    (the plain versions), then with the kernels, every layer of the kernel
    run started from the reference run's input to it (``_ForcedLayers``).
    A layer's k / v then come from the same input through P2 and P1 in
    another order, as layer 0's always do, and its output differs only by
    what the layer's own launches do.  K4's launches of the kernel run are
    held on their own operands (``_CheckedK4``, into ``k4_checks``); a
    paged step's reference keeps K4's kernel (``with_plain_but_k4``), so
    the layers are held apart from K4's order of summation, which on an
    ill-conditioned draw moves the softmax by percent (phase_k4_layers).
    Returns (each layer's max|output diff| / max|output|, the written rows'
    per-layer distances)."""
    import torch
    st, toks, pos = state
    with _ForcedLayers() as ref:
        _, st_p = reference(lambda: step(clone(st), toks, pos))
    with _ForcedLayers(ref.outs) as got, _CheckedK4(k4_checks):
        _, st_k = step(clone(st), toks, pos)
    errs = [rel_err(g, w) for g, w in zip(got.outs, ref.outs)]
    live = torch.ones(1, pos.shape[0], dtype=torch.bool, device="cuda")
    _, dist, _ = cache_checks("forced", st_k, st_p, pos, 1, kv_heads, live,
                              h0, whole_gate=False)
    return errs, dist


def direct_launch_cases(rows, p2, p1, k3):
    """The recorded P2, P1 and K3 launches of one decode step, each on its
    own operands: P2 bit for bit against plain on the CPU, P1 and the
    row-scaled K3 within the plain version's bound and the f64 product's
    over their promotion edges."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    sms = qmatmul.sm_count(0)
    for i, (a, kw, (q, s)) in enumerate(p2.calls):
        wq, ws = qmatmul.quantize_rows_plain(a[0].cpu(), *a[1:], **kw)
        bad = int((q.view(torch.uint8).cpu() != wq.view(torch.uint8)).sum()
                  + (s.cpu().view(torch.int32) != ws.view(torch.int32)).sum())
        rows.append({"case": f"p2 launch {i}", "differing": bad,
                     "max_abs_err": 0.0 if not bad else math.inf,
                     "max_err_over_bound": 0.0 if not bad else math.inf,
                     "ok": bad == 0})
    for i, (a, kw, got) in enumerate(p1.calls):
        xq, xs, w8, s = a[:4]
        m, k = xq.shape
        kper = qmatmul.w8a8_plan(m, w8.shape[1], k, sms).kper
        w8a8_gemm_case(rows, f"p1 launch {i}", got, got, xq, xs, w8, s,
                       qmatmul.w8a8_edges(k, kper), w8.shape[1])
    for i, (a, kw, got) in enumerate(k3.calls):
        x, w8, s = a[:3]
        xs = kw.get("row_scale", a[4] if len(a) > 4 else None)
        m, k = x.shape
        plan = qmatmul.weight_gemm_plan(m, w8.shape[1], k, sms, "w8", x, w8)
        edges = None if plan.route == "general" else \
            qmatmul.promotion_edges(k, plan.kper)
        w8a8_gemm_case(rows, f"k3 row-scaled launch {i}", got, got,
                       x.to(torch.float8_e4m3fn), xs, w8, s, edges,
                       w8.shape[1], fp8_sum=False)


def direct_steps(step, state, clone, steps, rows):
    """``steps`` decode steps of ``step(state, toks, pos)`` with the kernels,
    the plain versions and the exact-sum plain versions from one state,
    all fed the kernel run's greedy tokens; the first kernel step's P2 /
    P1 / K3 launches held on their own operands (``rows``).  Returns
    (kernels vs plain, exact vs plain: the worst max|logit diff| /
    max|logit| over the steps, the three final states, the starting
    positions)."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    st_k, toks, pos = state
    st_p, st_x = clone(st_k), clone(st_k)
    pos0 = pos.clone()
    d_k = d_x = 0.0
    for i in range(steps):
        if i == 0:
            with _Recording(qmatmul, "quantize_rows") as p2, \
                    _Recording(qmatmul, "w8a8_matmul") as p1, \
                    _Recording(qmatmul, "dequant_matmul") as k3:
                lk, st_k = step(st_k, toks, pos)
            direct_launch_cases(rows, p2, p1, k3)
            del p2, p1, k3
        else:
            lk, st_k = step(st_k, toks, pos)
        lp, st_p = with_plain_kernels(lambda: step(st_p, toks, pos))
        lx, st_x = with_exact_plain(lambda: step(st_x, toks, pos))
        top = float(lp.abs().max())
        if not bool(torch.isfinite(lk).all()):
            d_k = math.inf
        d_k = max(d_k, float((lk - lp).abs().max()) / top)
        d_x = max(d_x, float((lx - lp).abs().max()) / top)
        toks, pos = lk.argmax(-1).to(torch.int32), pos + 1
    return d_k, d_x, st_k, st_p, st_x, pos0


class _Admissions:
    """Keep the batch of every ``prefill_batch`` call of ``module`` while the
    context is open: (prompts, slots, lengths, the ring head as the call
    found it).  The engine's ring head moves on with every decode step, so
    it is copied at the call, in stream order."""

    def __init__(self, module):
        self.module, self.calls = module, []

    def __enter__(self):
        self.orig = self.module.prefill_batch

        def shim(params, ring, prompts, slots, lengths, *a, **kw):
            self.calls.append((prompts.clone(), slots.clone(),
                               lengths.clone(), ring.head.clone()))
            return self.orig(params, ring, prompts, slots, lengths, *a, **kw)

        self.module.prefill_batch = shim
        return self

    def __exit__(self, *exc):
        self.module.prefill_batch = self.orig


def replay_engine(params, scfg, admissions, prompts, out):
    """Every token ``out`` holds (a ring engine's greedy answers, SERVE_SLOTS
    slots) against a replay of each request in the engine's own summation
    order.  For each admission the engine made (``_Admissions``): its
    requests, told apart by their prompts, are prefilled in the rows and
    slots and at the (rows, length bucket) shape of the engine's call, from
    prompts built from the requests, on a fresh ring whose head is the
    engine's at that call; then one ``decode_chunk`` step at a time over
    the same slots, fed the engine's own tokens.  Every launch has the
    engine's shape and no kernel of the path mixes rows (P1, P2, the
    norms, the LM head) or slots (the ring attention), so each slot's
    numbers are the engine's bit for bit and its argmax must be the
    engine's token: a token that came from the wrong slot, position, ring
    row or prompt shows.  Returns ({uid: (step, engine token, replay
    token) of the first difference, or what went wrong}, steps
    compared)."""
    import torch
    from fp8tpu_torch.serve import RingKVCache, decode_chunk, prefill_batch
    cfg = scfg.model
    B = SERVE_SLOTS
    bad, seen, steps = {}, set(), 0
    for prompts_d, slots_d, lengths_d, head in admissions:
        n, sp = prompts_d.shape
        rows = []                               # (row, slot, uid)
        for j, (row, slot, ln) in enumerate(zip(prompts_d.tolist(),
                                                slots_d.tolist(),
                                                lengths_d.tolist())):
            if slot >= B:                       # a padding row of the bucket
                continue
            uid = next((u for u, p in prompts.items()
                        if p == row[:ln] and not any(row[ln:])), None)
            if uid is None or uid in seen:
                bad[("admission row", j)] = f"slot {slot}: prompt of no " \
                    "request, or of one admitted twice"
                continue
            seen.add(uid)
            rows.append((j, slot, uid))
        pr = torch.zeros((n, sp), dtype=torch.int32)
        sl = torch.full((n,), B, dtype=torch.int32)
        ln = torch.zeros((n,), dtype=torch.int32)
        for j, slot, uid in rows:
            pr[j, :len(prompts[uid])] = torch.tensor(prompts[uid])
            sl[j], ln[j] = slot, len(prompts[uid])
        ring = RingKVCache.create(cfg.n_layers, B, SERVE_SEQ, cfg.n_kv_heads,
                                  cfg.head_dim, scfg.kv_fmt)
        ring.head.copy_(head)
        zi = torch.zeros(B, device="cuda", dtype=torch.int32)
        first, ring, _, pos = prefill_batch(
            params, ring, pr.cuda(), sl.cuda(), ln.cuda(), None,
            torch.zeros(n, device="cuda"),
            torch.zeros(n, device="cuda", dtype=torch.int32),
            torch.ones(n, device="cuda"), zi, zi.clone(), scfg)
        got = [first[[j for j, _, _ in rows]]]
        temps = torch.zeros(B, device="cuda")
        for t in range(1, SERVE_NEW):
            toks = [0] * B
            for _, slot, uid in rows:
                toks[slot] = out[uid][t - 1]
            o, _, ring, _, pos = decode_chunk(
                params, ring, torch.tensor(toks, device="cuda",
                                           dtype=torch.int32),
                pos, None, temps, 1, scfg, greedy_only=True)
            got.append(o[[slot for _, slot, _ in rows], 0])
        got = torch.stack(got, 1).tolist()      # (requests, SERVE_NEW)
        for (_, _, uid), g in zip(rows, got):
            steps += len(g)
            diff = next((t for t in range(SERVE_NEW) if g[t] != out[uid][t]),
                        None)
            if diff is not None:
                bad[uid] = (diff, out[uid][diff], g[diff])
        del ring
    for uid in set(out) - seen:
        bad[uid] = "never admitted"
    return bad, steps


W8A8_COPIES = 8                # weights a timed GEMM turns over


def rotating(weights, fn):
    """A call of ``fn(w, s)`` on the next of ``weights`` each time."""
    state = {"i": -1}

    def call():
        state["i"] = (state["i"] + 1) % len(weights)
        return fn(*weights[state["i"]])
    return call


def codes_route():
    """Whether the loaded package's P2 writes the codes in the GEMM's type
    (``quantize_rows(..., codes_dtype=)``) and its int8 direct linear is
    two launches; a parent tree's package (``--package-tree``) may not."""
    import inspect
    from fp8tpu_torch.kernels import qmatmul
    return "codes_dtype" in inspect.signature(qmatmul.quantize_rows).parameters


def weight_copies(gen, k, n, fmt, copies=W8A8_COPIES):
    """``copies`` random (k, n) weights quantized to ``fmt``: [(payload,
    scales (n,))]."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    out = []
    for _ in range(copies):
        w = torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5
        w8, s = qmatmul.quantize_weights(w, fmt)
        out.append((w8, s.reshape(-1)))
        del w
    return out


def int8_route_bound(m, n, k):
    """(ms, "bytes" or "operations"): K3's int8 route on 2-byte codes: the
    weight, x's codes, both scales and the bf16 output at 3.35 TB/s, or
    2 M N K at the bf16 / f16 tensor-core rate."""
    t_bytes = (k * n + 2.0 * m * k + 4.0 * (m + n) + 2.0 * m * n) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * m * n * k / BF16_TC_FLOPS * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def time_int8_route(gen, k, n, proj):
    """W8A8's int8 route on int8 weights (W8A8_COPIES of them, turned over:
    cold, trap 27) at M in W8A8_TIME_MS, its launches apart and together,
    by CUDA-graph replay: P2, the convert of its codes to bf16 (the
    parent's route) and K3 row-scaled on them; the whole direct linear as
    serve.model.fp8_linear makes it.  Where P2 writes codes (codes_route),
    also P2 with f16 codes, K3's int8 route on them, and the two end to
    end."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    from fp8tpu_torch.serve import model as smodel
    from fp8tpu_torch.tools import device_ms
    w8s = weight_copies(gen, k, n, "int8")
    w8, s = w8s[0]
    codes = codes_route()
    rows = []
    for m in W8A8_TIME_MS:
        x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
        xq, xs = qmatmul.quantize_rows(x)
        xs = xs.reshape(-1)
        xb = xq.to(torch.bfloat16)
        want = qmatmul.dequant_matmul_plain(xb, w8, s, torch.bfloat16, xs)
        row = {"proj": proj, "m": m, "k": k, "n": n,
               "weights": "int8", "weight_copies": W8A8_COPIES}
        row["p2_ms"] = device_ms(lambda: qmatmul.quantize_rows(x))
        row["convert_ms"] = device_ms(lambda: xq.to(torch.bfloat16))
        row["k3_bf16_ms"] = device_ms(rotating(
            w8s, lambda w, s_: qmatmul.dequant_matmul(
                xb, w, s_, torch.bfloat16, xs)))
        row["linear_ms"] = device_ms(rotating(
            w8s, lambda w, s_: smodel.fp8_linear(x, w, s_, "direct")))
        got = smodel.fp8_linear(x, w8, s, "direct")
        row["err"] = float((got.float() - want.float()).abs().max())
        row["plain_ms"] = cuda_ms(lambda: qmatmul.dequant_matmul_plain(
            xb, w8, s, torch.bfloat16, xs), iters=3, warmup=1)
        row["bound_ms"], row["bound_by"] = int8_route_bound(m, n, k)
        row["p2_bound_ms"] = (3.0 * m * k + 4.0 * m) / HBM_BYTES_PER_S * 1e3
        text = (f"P2 {row['p2_ms']:.4f}, convert {row['convert_ms']:.4f}, "
                f"K3 on bf16 codes {row['k3_bf16_ms']:.4f}")
        if codes:
            xh, _ = qmatmul.quantize_rows(x, codes_dtype=torch.float16)
            row["p2_f16_ms"] = device_ms(lambda: qmatmul.quantize_rows(
                x, codes_dtype=torch.float16))
            row["k3_f16_ms"] = device_ms(rotating(
                w8s, lambda w, s_: qmatmul.dequant_matmul(
                    xh, w, s_, torch.bfloat16, xs)))

            def pair(w, s_):
                q, r = qmatmul.quantize_rows(x, codes_dtype=torch.float16)
                return qmatmul.dequant_matmul(q, w, s_, torch.bfloat16,
                                              r.reshape(-1))
            row["pair_f16_ms"] = device_ms(rotating(w8s, pair))
            row["p2_bound_ms"] = (4.0 * m * k + 4.0 * m) / HBM_BYTES_PER_S \
                * 1e3
            text += (f"; P2 with f16 codes {row['p2_f16_ms']:.4f}, K3 on "
                     f"them {row['k3_f16_ms']:.4f}, P2 + K3 "
                     f"{row['pair_f16_ms']:.4f}")
        rows.append(row)
        print(f"time w8a8 int8 route {proj} {k}x{n} M={m}, int8 weights: "
              f"{text}; the direct linear {row['linear_ms']:.4f} ms (bound "
              f"{row['bound_ms']:.4f} {row['bound_by']}, plain "
              f"{row['plain_ms']:.4f}, max|err| {row['err']:.3e})",
              flush=True)
    return rows


W8A8_ROUTE_SHAPES = (((4096, 11008), "gate"), ((4096, 1024), "k/v"),
                     ((2048, 5504), "moe up"))


def time_w8a8_kernels(record):
    """P1, P2, K3 convert and torch._scaled_mm at M in W8A8_TIME_MS on the
    gate projection (4096 x 11008) and k/v (4096 x 1024), P2 also at
    (2048, 11008), by CUDA-graph replay, the GEMMs turning over
    W8A8_COPIES weights; then the int8 route on int8 weights there and at
    the MoE expert's up projection (time_int8_route).  Returns the rows.
    A parent tree is timed by this script with ``--package-tree`` in the
    same call, in turns (the verify notes give the command)."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    from fp8tpu_torch.tools import device_ms

    gen = torch.Generator(device="cuda").manual_seed(36)
    rows = []
    for (k, n), proj in W8A8_ROUTE_SHAPES[:2]:
        # W8A8_COPIES weights, a launch on each in turn: the timed launch
        # streams its weight from device memory, not from the 50 MB L2
        w8s = weight_copies(gen, k, n, "e4m3")
        w5s = weight_copies(gen, k, n, "e5m2")
        # column-major copies, for torch._scaled_mm only
        cms = {"e4m3": [(w.t().contiguous().t(), s) for w, s in w8s],
               "e5m2": [(w.t().contiguous().t(), s) for w, s in w5s]}
        w8, s = w8s[0]
        for m in W8A8_TIME_MS:
            x = torch.randn(m, k, device="cuda", generator=gen
                            ).to(torch.bfloat16)
            xq, xs = qmatmul.quantize_rows(x)
            xs = xs.reshape(-1)
            got = qmatmul.w8a8_matmul(xq, xs, w8, s)
            want = qmatmul.w8a8_matmul_plain(xq, xs, w8, s)
            err = float((got.float() - want.float()).abs().max())
            qw = qmatmul.quantize_rows_plain(x)
            p2_err = float((xq.float() - qw[0].float()).abs().max())
            t_p1 = device_ms(rotating(w8s, lambda w, s_: qmatmul.w8a8_matmul(
                xq, xs, w, s_)))
            t_p1_e5 = device_ms(rotating(w5s, lambda w, s_:
                                         qmatmul.w8a8_matmul(xq, xs, w, s_)))
            t_p2 = device_ms(lambda: qmatmul.quantize_rows(x))
            t_k3 = device_ms(rotating(w8s, lambda w, s_:
                                      qmatmul.dequant_matmul(x, w, s_)))
            t_p1_plain = cuda_ms(lambda: qmatmul.w8a8_matmul_plain(
                xq, xs, w8, s), iters=3, warmup=1)
            t_p2_plain = cuda_ms(lambda: qmatmul.quantize_rows_plain(x),
                                 iters=3, warmup=1)
            lib_ms = {}
            for label, ws in cms.items():
                try:
                    lib_ms[label] = device_ms(rotating(ws, lambda w, s_:
                                                       torch._scaled_mm(
                        xq, w, scale_a=xs.reshape(-1, 1),
                        scale_b=s_.reshape(1, -1), out_dtype=torch.bfloat16)))
                except Exception as e:      # recorded, not hidden
                    lib_ms[label] = f"refused: {type(e).__name__}: {e}"[:160]
            t_bytes = (m * k + k * n + 4.0 * (m + n) + 2.0 * m * n) \
                / HBM_BYTES_PER_S * 1e3
            t_ops = 2.0 * m * n * k / FP8_TC_FLOPS * 1e3
            b1, by1 = max(t_bytes, t_ops), ("operations" if t_ops > t_bytes
                                            else "bytes")
            b2 = (3.0 * m * k + 4.0 * m) / HBM_BYTES_PER_S * 1e3
            k3_bytes = (2.0 * m * k + k * n + 4.0 * n + 2.0 * m * n) \
                / HBM_BYTES_PER_S * 1e3
            b3 = max(k3_bytes, 2.0 * m * n * k / BF16_TC_FLOPS * 1e3)
            row = {"proj": proj, "m": m, "k": k, "n": n, "p1_ms": t_p1,
                   "p1_e5m2_ms": t_p1_e5, "p1_plain_ms": t_p1_plain,
                   "p1_bound_ms": b1, "p1_bound_by": by1, "p1_err": err,
                   "p2_ms": t_p2, "p2_plain_ms": t_p2_plain,
                   "p2_bound_ms": b2, "p2_err": p2_err,
                   "k3_convert_ms": t_k3, "k3_bound_ms": b3,
                   "scaled_mm_ms": lib_ms, "weight_copies": W8A8_COPIES}
            rows.append(row)
            print(f"time w8a8 {proj} {k}x{n} M={m}: P1 {t_p1:.4f} ms (e5m2 "
                  f"{t_p1_e5:.4f}; plain {t_p1_plain:.4f}, bound {b1:.4f} "
                  f"{by1}), P2 {t_p2:.4f} ms (plain {t_p2_plain:.4f}, bound "
                  f"{b2:.4f} bytes), K3 convert {t_k3:.4f} ms (bound "
                  f"{b3:.4f}) on e4m3 weights, torch._scaled_mm {lib_ms}",
                  flush=True)
        del w8s, w5s, cms, w8
    # P2 on the widest serving row (the down projection's input)
    for m, k in ((8, 4096), (2048, 4096), (2048, 11008)):
        x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
        t_p2 = device_ms(lambda: qmatmul.quantize_rows(x))
        b2 = (3.0 * m * k + 4.0 * m) / HBM_BYTES_PER_S * 1e3
        row = {"proj": "p2 only", "m": m, "k": k, "p2_ms": t_p2,
               "p2_bound_ms": b2}
        if codes_route():
            row["p2_f16_ms"] = device_ms(lambda: qmatmul.quantize_rows(
                x, codes_dtype=torch.float16))
        rows.append(row)
        print(f"time w8a8 P2 ({m}, {k}): {t_p2:.4f} ms (bound {b2:.4f} "
              f"bytes){'' if 'p2_f16_ms' not in row else f', f16 codes ' + format(row['p2_f16_ms'], '.4f') + ' ms'}",
              flush=True)
    for (k, n), proj in W8A8_ROUTE_SHAPES:
        rows += time_int8_route(gen, k, n, proj)
    record.setdefault("time", {})["w8a8_kernels"] = rows
    torch.cuda.empty_cache()
    return rows


def scaled_mm_p1(xq, xs, w8, s, out_dtype=None, promote=None):
    """P1's function by torch._scaled_mm (cuBLASLt's fp8 GEMM, row-wise
    scales, e4m3 weights copied column-major): the forced step's control,
    used nowhere in the port."""
    import torch
    return torch._scaled_mm(xq, w8.t().contiguous().t(),
                            scale_a=xs.reshape(-1, 1).float(),
                            scale_b=s.reshape(1, -1).float(),
                            out_dtype=out_dtype or torch.bfloat16)


def vendor_sums(rows, gen, ms=(1, 8, 64, 65, 512)):
    """P1's f32 sums (unit scales, e4m3 weights) against cuBLASLt's fp8
    GEMM (torch._scaled_mm, tensor-wise unit scales) at the W8A8 shapes,
    element by element: both sum on the fp8 tensor cores, 13 bits below a
    step's largest addend, in chunks of 128 K rows promoted in f32."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    one = torch.ones((), device="cuda")
    for k, n in W8A8_KN:
        w8, _ = qmatmul.quantize_weights(
            torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5)
        wc = w8.t().contiguous().t()
        for m in ms:
            x = torch.randn(m, k, device="cuda", generator=gen
                            ).to(torch.bfloat16)
            xq, _ = qmatmul.quantize_rows(x)
            got = qmatmul.w8a8_matmul(xq, torch.ones(m, device="cuda"), w8,
                                      torch.ones(n, device="cuda"),
                                      torch.float32)
            want = torch._scaled_mm(xq, wc, scale_a=one, scale_b=one,
                                    out_dtype=torch.float32)
            bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            rows.append({"case": f"p1 f32 sums vs cuBLASLt M={m} K={k} "
                                 f"N={n}", "differing": bad,
                         "elements": m * n,
                         "max_abs_err": float((got - want).abs().max()),
                         "max_err_over_bound": 0.0 if not bad else math.inf,
                         "ok": bad == 0})
            if bad:
                print(f"  FAIL {rows[-1]['case']}: {bad} of {m * n} sums "
                      "differ")


W8A8_CHUNKS = (1, 2, 4)           # k32 steps a chunk, w8a8_p1probe's


def w8a8_forced_layers(record, chunks=W8A8_CHUNKS):
    """What P1's chunk length does to a direct decode step (batch 64, e4m3
    weights, the ring and the paged pool): forced_step against the f32
    plain version (the w8a8 phase's gate) with P1 summing in chunks of
    each of ``chunks`` k32 steps, and two controls in P1's place:
    cuBLASLt's fp8 GEMM (scaled_mm_p1: the fp8 tensor cores' sums) and the
    exact-sum plain product (f32-grade sums in another order)."""
    import dataclasses
    from fp8tpu_torch.kernels import qmatmul
    from fp8tpu_torch.serve import (ServeConfig, decode_step,
                                    decode_step_paged, random_serve_params)
    cfg = serve_config()
    if "e4m3" not in STATE:
        STATE["e4m3"] = random_serve_params(cfg, "e4m3", seed=0)
    prm = STATE["e4m3"]
    scfg = ServeConfig(model=cfg, weight_fmt="e4m3", kv_fmt="int8",
                       matmul_impl="direct")
    kcfg = dataclasses.replace(scfg, paged_decode_impl="kernel")
    rows = []
    for name, step, make, clone, ref in (
            ("ring", lambda st, t, p: decode_step(prm, st, t, p, scfg),
             lambda: w8a8_ring_state(prm, scfg), clone_ring,
             with_plain_kernels),
            ("paged kernel",
             lambda st, t, p: decode_step_paged(prm, st, t, p, kcfg),
             lambda: w8a8_pool_state(prm, kcfg), clone_pool,
             with_plain_but_k4)):
        state = make()
        h0 = int(state[0].head) if name == "ring" else None
        orig = qmatmul.W8A8_PROMOTE, qmatmul.w8a8_matmul
        controls = {"cuBLASLt": scaled_mm_p1, "exact": w8a8_plain_exact}
        for chunk in (*chunks, *controls):
            try:
                if chunk in controls:
                    qmatmul.w8a8_matmul = controls[chunk]
                else:
                    qmatmul.W8A8_PROMOTE = chunk
                errs, dist = forced_step(step, state, clone,
                                         cfg.n_kv_heads, h0, [], ref)
            finally:
                qmatmul.W8A8_PROMOTE, qmatmul.w8a8_matmul = orig
            label = {"cuBLASLt": "cuBLASLt's fp8 GEMM",
                     "exact": "exact-sum plain"}.get(
                chunk, f"P1 at chunks of {chunk} k32 steps")
            rows.append({"cache": name, "chunk": chunk, "layer_out": errs,
                         "equal": [d["equal"] for d in dist]})
            print(f"w8a8_p1probe forced step, {name}, {label}: layer "
                  f"outputs max|diff| / max|out| [{', '.join(f'{e:.2e}' for e in errs)}] "
                  f"(max {max(errs):.3e}); written rows equal min "
                  f"{min(d['equal'] for d in dist):.4f}", flush=True)
        del state
    record.setdefault("w8a8_p1probe", {})["forced"] = rows


def phase_w8a8_p1probe(record):
    """What P1's chunk length (k32 steps the fp8 tensor cores sum before
    the f32 promotion) costs and buys: its time (CUDA-graph replay, e4m3,
    W8A8_COPIES weights) on the gate and k/v at M = 8, 64 (the decode
    form) and 512, 2048 (the prefill route) at chunks of W8A8_CHUNKS, and
    of 8, 16, 32 on the gate at M = 2048; the prefill route at K = 1024 ..
    8192 beside K3 (a tile's fixed cost beside its cost a stage); and a
    decode step's layers at each chunk (w8a8_forced_layers)."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    from fp8tpu_torch.tools import device_ms
    gen = torch.Generator(device="cuda").manual_seed(37)
    rows = []

    def copies(k, n):
        out = []
        for _ in range(W8A8_COPIES):
            w8, s = qmatmul.quantize_weights(
                torch.randn(k, n, device="cuda", generator=gen) / k ** 0.5)
            out.append((w8, s.reshape(-1)))
        return out

    for (k, n), proj in (((4096, 11008), "gate"), ((4096, 1024), "k/v")):
        ws_ = copies(k, n)
        for m in W8A8_TIME_MS:
            x = torch.randn(m, k, device="cuda", generator=gen
                            ).to(torch.bfloat16)
            xq, xs = qmatmul.quantize_rows(x)
            xs = xs.reshape(-1)
            more = (8, 16, 32) if proj == "gate" and m == 2048 else ()
            for chunk in (*W8A8_CHUNKS, *more):
                t = device_ms(rotating(ws_, lambda w, s_: qmatmul.w8a8_matmul(
                    xq, xs, w, s_, promote=chunk)))
                rows.append({"proj": proj, "m": m, "k": k, "n": n,
                             "promote": chunk, "p1_ms": t})
                print(f"w8a8_p1probe P1 {proj} M={m} K={k} N={n} chunk "
                      f"{chunk} k32 steps: {t:.4f} ms "
                      f"({2.0 * m * n * k / t / 1e9:.1f} TFLOP/s)",
                      flush=True)
        del ws_
    m, n = 2048, 11008
    for k in (1024, 2048, 8192):
        ws_ = copies(k, n)
        x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
        xq, xs = qmatmul.quantize_rows(x)
        xs = xs.reshape(-1)
        t = device_ms(rotating(ws_, lambda w, s_: qmatmul.w8a8_matmul(
            xq, xs, w, s_)))
        t3 = device_ms(rotating(ws_, lambda w, s_: qmatmul.dequant_matmul(
            x, w, s_)))
        rows.append({"k": k, "p1_ms": t, "k3_ms": t3})
        print(f"w8a8_p1probe M={m} K={k} N={n}: P1 {t:.4f} ms, K3 "
              f"{t3:.4f} ms", flush=True)
        del ws_
    record.setdefault("w8a8_p1probe", {})["times"] = rows
    torch.cuda.empty_cache()
    w8a8_forced_layers(record)


def time_w8a8(record, launches):
    """time_w8a8_kernels, then one batch-64 decode step and one 8 x 256
    paged prefill, direct against convert in turns.  Returns the kernels
    line's entries."""
    import torch
    rows = time_w8a8_kernels(record)
    entries = []

    def pick(proj, m):
        return next(r for r in rows if r["proj"] == proj and r["m"] == m
                    and "weights" not in r)

    for name, key, r in (
            ("w8a8_matmul (gate, M = 8)", "w8a8_matmul", pick("gate", 8)),
            ("w8a8_matmul_prefill (gate, M = 2048)", "w8a8_matmul_prefill",
             pick("gate", 2048))):
        lib = r["scaled_mm_ms"]["e4m3"]
        entries.append({
            "name": name, "route": "cuda",
            "source": "fp8tpu_torch/kernels/csrc/w8a8.cu",
            "replaces": "fp8tpu/serve/model.py:115 (an XLA dot, no TPU "
                        "kernel)",
            "launches": launches[key], "max_abs_err": r["p1_err"],
            "ms": r["p1_ms"], "plain_ms": r["p1_plain_ms"],
            "bound_ms": r["p1_bound_ms"], "bound_by": r["p1_bound_by"],
            "library_ms": lib if isinstance(lib, float) else None})
    for name, key, m in (
            ("dequant_matmul int8 route (gate, M = 8)", "dequant_matmul_int8",
             8),
            ("dequant_matmul int8 route prefill (gate, M = 2048)",
             "dequant_matmul_int8_prefill", 2048)):
        r = next(r for r in rows if r["proj"] == "gate" and r["m"] == m
                 and r.get("weights") == "int8")
        entries.append({
            "name": name, "route": "cuda",
            "source": "fp8tpu_torch/kernels/csrc/dequant_matmul.cu",
            "replaces": "fp8tpu/serve/model.py:115 (an XLA dot, no TPU "
                        "kernel)",
            "launches": launches[key], "max_abs_err": r["err"],
            "ms": r["k3_f16_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    r = pick("gate", 8)
    entries.append({
        "name": "quantize_rows (M = 8, K = 4096)", "route": "cuda",
        "source": "fp8tpu_torch/kernels/csrc/w8a8.cu",
        "replaces": "fp8tpu/serve/model.py:201 (XLA ops, no TPU kernel)",
        "launches": launches["quantize_rows"], "max_abs_err": r["p2_err"],
        "ms": r["p2_ms"], "plain_ms": r["p2_plain_ms"],
        "bound_ms": r["p2_bound_ms"], "bound_by": "bytes",
        "library_ms": None})
    result = {"kernels": rows}
    result["decode"] = time_direct_step()
    result["prefill"] = time_direct_prefill()
    record.setdefault("time", {})["w8a8"] = result
    STATE.pop("int8", None)
    two_launches(result)
    return entries


def two_launches(result):
    """Each profile of a direct-int8 step or prefill holds 7 L P2 and 7 L K3
    launches and as many launches in all as the direct-e4m3 one (P2, P1):
    no convert launch lies between P2 and K3."""
    L = serve_config().n_layers
    problems = []
    for part in ("decode", "prefill"):
        base = result[part]["e4m3 direct"][0]["profile"]["launches"]
        for run in result[part]["int8 direct"]:
            prof = run["profile"]
            counts = {g: prof["groups"].get(g, (0.0, 0))[1] for g in (
                "P2 row quantizer (hand-written)",
                "K3/K5 weight GEMM (hand-written)")}
            if set(counts.values()) != {7 * L} or prof["launches"] != base:
                problems.append(f"{part}: {counts}, {prof['launches']} "
                                f"launches against direct e4m3's {base}")
    print(f"time w8a8: the direct-int8 profiles hold 7 L = {7 * L} P2 and "
          f"K3 launches and no launch more than direct e4m3's: "
          f"{'yes' if not problems else problems}")
    if problems:
        raise PhaseError("a direct-int8 linear is not two launches: "
                         + "; ".join(problems))


def wrapper_counts(run):
    """{profile group: launches} of one ``run()`` of the hand-written
    kernels, as their wrappers count them (each adds one where it launches
    its kernel)."""
    from fp8tpu_torch.kernels import inplace, int4_matmul, qmatmul
    from fp8tpu_torch.kernels import paged_attention as k4
    counters = (
        ("K3/K5 weight GEMM (hand-written)",
         lambda: qmatmul.dequant_launches + int4_matmul.launches),
        ("P1 fp8 x fp8 GEMM (hand-written)", lambda: qmatmul.w8a8_launches),
        ("P2 row quantizer (hand-written)",
         lambda: qmatmul.quantize_launches),
        ("K4 paged attention (hand-written)", lambda: k4.launches),
        ("K6 ring store (hand-written)", lambda: inplace.launches))
    before = [c() for _, c in counters]
    run()
    return {g: c() - b for (g, c), b in zip(counters, before)}


def counted_profile(run, best, want):
    """profile_decode_step of ``run``, taken again (up to three times) while
    its records of a hand-written kernel differ in number from ``want``
    ({group: launches}, from wrapper_counts); fails when none of the three
    holds them all.  Returns (profile, attempts)."""
    for attempt in range(1, 4):
        prof = profile_decode_step(run, best)
        got = {g: prof["groups"].get(g, (0.0, 0))[1] for g in want}
        if got == want:
            return prof, attempt
    raise PhaseError(f"torch.profiler recorded {got} launches of the "
                     f"hand-written kernels where the wrappers counted {want} "
                     "(3 profiles)")


DIRECT_SEEDS = {"e4m3": 0, "int8": 32}     # random_serve_params' seeds


def serve_params_of(fmt):
    """The serve cell's random parameters with ``fmt`` weights, kept in
    STATE (e4m3 from seed 0, int8 from seed 32)."""
    from fp8tpu_torch.serve import random_serve_params
    if fmt not in STATE:
        STATE[fmt] = random_serve_params(serve_config(), fmt,
                                         seed=DIRECT_SEEDS[fmt])
    return STATE[fmt]


def time_direct_step(fmts=("e4m3", "int8")):
    """One batch-64 decode step at position 444 (ring of 512, int8 KV), for
    each of ``fmts`` weights convert and direct in turns (convert, direct,
    direct, convert): wall clock of an 8-step chunk (best of 3) and a
    torch.profiler breakdown of one step.  Returns {"<fmt> <impl>":
    [runs]}."""
    import torch
    from fp8tpu_torch.serve import RingKVCache, ServeConfig, decode_steps
    cfg = serve_config()
    L, KV, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(37)
    ring = RingKVCache.create(L, BENCH_BATCH, BENCH_CACHE, KV, D, "int8")
    ring.kv8.copy_(torch.randint(-127, 128, ring.kv8.shape, device="cuda",
                                 generator=gen, dtype=torch.int8))
    ring.sc.uniform_(0.004, 0.02, generator=gen)
    toks = torch.randint(1, cfg.vocab_size, (BENCH_BATCH,), device="cuda",
                         generator=gen, dtype=torch.int32)
    pos = torch.full((BENCH_BATCH,), BENCH_WARM_POS, device="cuda",
                     dtype=torch.int32)
    temp = torch.zeros(BENCH_BATCH, device="cuda")
    out = {}
    for fmt in fmts:
        params = serve_params_of(fmt)
        for impl in ("convert", "direct", "direct", "convert"):
            scfg = ServeConfig(model=cfg, weight_fmt=fmt, kv_fmt="int8",
                               matmul_impl=impl)

            def chunk(n):
                ring.head.fill_(BENCH_WARM_POS)
                o, _ = decode_steps(params, ring, toks, pos, None, temp, n,
                                    scfg, greedy_only=True)
                return o

            chunk(2)
            torch.cuda.synchronize()
            walls = []
            for _ in range(3):
                t = time.perf_counter()
                int(chunk(8).sum())
                walls.append((time.perf_counter() - t) / 8 * 1e3)
            want = wrapper_counts(lambda: chunk(1))
            prof, tries = counted_profile(lambda: chunk(1), min(walls), want)
            out.setdefault(f"{fmt} {impl}", []).append({
                "wall_ms": walls, "profile": prof, "profiles_taken": tries,
                "wrapper_counts": want})
            print(f"time w8a8 decode step, batch {BENCH_BATCH}, {fmt} "
                  f"weights, {impl}: {min(walls):.3f} ms wall (chunks of 8: "
                  f"{[round(w, 3) for w in walls]}), {prof['device_ms']:.3f} "
                  f"ms of kernels in {prof['launches']} launches, busy share "
                  f"{prof['busy_share']:.3f} (profiles taken {tries})")
            for group, (ms_, n_) in prof["groups"].items():
                print(f"    {ms_:8.3f} ms {n_:5d}x  {group}")
    del ring
    return out


def time_direct_prefill(fmts=("e4m3", "int8")):
    """One paged prefill of 8 x 256 tokens (2048 rows a linear), for each of
    ``fmts`` weights convert and direct in turns: wall clock (best of 3)
    and a profile of one call."""
    import torch
    from fp8tpu_torch.serve import ServeConfig
    cfg = serve_config()
    B, T = SERVE_SLOTS, PREFILL_TOKENS
    out = {}
    for fmt in fmts:
        params = serve_params_of(fmt)
        for impl in ("convert", "direct", "direct", "convert"):
            scfg = ServeConfig(model=cfg, weight_fmt=fmt, kv_fmt="int8",
                               paged_decode_impl="kernel", matmul_impl=impl)
            run = prefill_runner(params, scfg, 38)
            run()
            torch.cuda.synchronize()
            times = []
            for _ in range(3):
                t = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            want = wrapper_counts(run)
            prof, tries = counted_profile(run, min(times), want)
            out.setdefault(f"{fmt} {impl}", []).append({
                "wall_ms": times, "profile": prof, "profiles_taken": tries,
                "wrapper_counts": want})
            print(f"time w8a8 paged prefill {B} x {T}, {fmt} weights, "
                  f"{impl}: {min(times):.3f} ms wall (best of 3), "
                  f"{prof['device_ms']:.3f} ms of kernels in "
                  f"{prof['launches']} launches, busy share "
                  f"{prof['busy_share']:.3f} (profiles taken {tries})")
            for group, (ms_, n_) in prof["groups"].items():
                print(f"    {ms_:8.3f} ms {n_:5d}x  {group}")
            del run
    return out


# -- phase deploy ----------------------------------------------------------------

DEPLOY_DIR = "chip_smoke_out/deploy_artifact"
DEPLOY_LOGIT_TOL = 1e-3        # the fold against the float model, of max|logit|


def phase_deploy(record):
    """The deployment path at full width: a float Decoder (serve_config's
    widths, f32, random from a seed), calibration tokens from
    fp8tpu_torch.data, awq_calibrate_decoder (e4m3), the artifact through
    disk (save_serve_artifact / load_serve_artifact, byte for byte), an
    EngineServer with direct linears on the loaded artifact; then the same
    calibration for int4 (groups of 128, K5) served from memory."""
    import dataclasses
    import shutil
    import torch
    from fp8tpu_torch._device import full_fp32
    from fp8tpu_torch.data import induction_tokens
    from fp8tpu_torch.models import decoder
    from fp8tpu_torch.quant import awq_calibrate_decoder
    from fp8tpu_torch.serve import ServeConfig, convert_decoder_params
    from fp8tpu_torch.serve import engine as engine_mod
    from fp8tpu_torch.utils import load_serve_artifact, save_serve_artifact

    cfg = serve_config()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    result, problems = {}, []
    t0 = time.perf_counter()
    # drawn on the card: an f32 draw of 11.9 GB on the host took 45 s
    model = decoder(cfg32, generator=torch.Generator("cuda").manual_seed(40))
    variables = {k: v.detach() for k, v in model.state_dict().items()}
    nbytes = sum(v.numel() * v.element_size() for v in variables.values())
    # markov_tokens would need a (V, V, V) transition table at V = 32768;
    # the induction corpus covers the whole vocabulary
    tokens = torch.from_numpy(induction_tokens(32, 256, vocab=cfg.vocab_size,
                                               seed=41)).cuda()
    print(f"deploy: float decoder ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, f32) {nbytes / 1e9:.2f} GB made in "
          f"{time.perf_counter() - t0:.1f} s; 32 x 256 calibration tokens")
    probe = tokens[:2]
    with torch.no_grad(), full_fp32():
        base = model(probe)
    prompts = {r.uid: r.prompt for r in serve_requests(7, 16, cfg.vocab_size)}
    for fmt in ("e4m3", "int4"):
        t0 = time.perf_counter()
        eq, info = awq_calibrate_decoder(model, variables, cfg32, tokens,
                                         fmt=fmt, int4_group=128)
        t_awq = time.perf_counter() - t0
        with torch.no_grad(), full_fp32():
            after = torch.func.functional_call(model, eq, (probe,))
        rel = float((after - base).abs().max() / base.abs().max())
        alphas = {li: {s: r["alpha"] for s, r in sites.items()}
                  for li, sites in info.items()}
        worse = [(li, s) for li, sites in info.items()
                 for s, r in sites.items()
                 if r["err"] > r["err_identity"]]
        print(f"deploy {fmt}: awq_calibrate_decoder in {t_awq:.1f} s; the "
              f"float model before and after the fold on 2 x 256 tokens: "
              f"max|diff| / max|logit| {rel:.3e} (at most "
              f"{DEPLOY_LOGIT_TOL}); sites whose error exceeds identity's "
              f"{worse or 'none'}; alphas {alphas}")
        if rel > DEPLOY_LOGIT_TOL or worse:
            problems.append(f"deploy {fmt}: fold moved the float logits by "
                            f"{rel}, sites worse than identity {worse}")
        del after
        art = convert_decoder_params(eq, cfg, fmt, int4_group=128)
        del eq
        scfg = ServeConfig(model=cfg, weight_fmt=fmt, kv_fmt="int8",
                           matmul_impl="direct")
        entry = {"awq_seconds": t_awq, "fold_rel_logit_diff": rel,
                 "alphas": alphas, "worse_than_identity": worse}
        if fmt == "e4m3":
            here = os.path.dirname(os.path.abspath(__file__))
            path = os.path.join(here, DEPLOY_DIR)
            shutil.rmtree(path, ignore_errors=True)
            try:
                t0 = time.perf_counter()
                save_serve_artifact(path, art, scfg)
                t_save = time.perf_counter() - t0
                size = sum(os.path.getsize(os.path.join(path, f))
                           for f in os.listdir(path))
                t0 = time.perf_counter()
                loaded, lcfg = load_serve_artifact(path)
                t_load = time.perf_counter() - t0
            finally:
                shutil.rmtree(path, ignore_errors=True)
            differ = sorted(k for k in art if k not in loaded or not (
                loaded[k].dtype == art[k].dtype
                and loaded[k].shape == art[k].shape
                and torch.equal(loaded[k].contiguous().view(torch.uint8),
                                art[k].contiguous().view(torch.uint8))))
            print(f"deploy e4m3: artifact of {len(art)} arrays, "
                  f"{size / 1e9:.3f} GB on disk, saved in {t_save:.1f} s, "
                  f"loaded in {t_load:.1f} s; arrays that differ from "
                  f"memory {differ or 'none'}, config equal "
                  f"{lcfg == scfg}")
            if differ or lcfg != scfg or set(loaded) != set(art):
                problems.append(f"the loaded artifact differs: {differ}")
            entry.update(artifact_bytes=size, save_seconds=t_save,
                         load_seconds=t_load, differing=differ)
            art = loaded
        with _Admissions(engine_mod) as adm:
            out, seconds, _ = run_server(art, scfg, 16)
        n_tok = sum(len(v) for v in out.values())
        if fmt == "e4m3":           # direct: the engine's own order replayed
            bad, steps = replay_engine(art, scfg, adm.calls, prompts, out)
            how = (f"the replay of each admission in the engine's order: "
                   f"{steps} tokens compared, tokens that differ")
            bad = {str(k): v for k, v in bad.items()}
            if steps != n_tok:
                bad["compared"] = steps
        else:                       # int4 takes K5 whatever matmul_impl says
            _, drift, bad, band = margin_agree(out, out, prompts, art, scfg)
            how = (f"against the teacher-forced dense forward: steps inside "
                   f"the margin band {drift:.3e}, tokens inside the band a "
                   f"step {band:.2f}, tokens outside it")
        print(f"deploy {fmt}: EngineServer ({'direct' if fmt == 'e4m3' else 'K5'}"
              f" linears, int8 KV) answered 16 requests, {n_tok} tokens in "
              f"{seconds:.2f} s; {how} {bad or 'none'}")
        if bad or any(len(v) != SERVE_NEW for v in out.values()):
            problems.append(f"deploy {fmt}: tokens off their check {bad}")
        entry.update(tokens=n_tok, seconds=seconds, off_check=bad)
        result[fmt] = entry
        del art
        torch.cuda.empty_cache()
    del model, variables
    torch.cuda.empty_cache()
    record["deploy"] = result
    if problems:
        raise PhaseError("; ".join(problems))


# -- phase flush ---------------------------------------------------------------

FLUSH_W = 8                    # the batched ring write of the timed chunk
FLUSH_STEPS = 32               # its chunk: 4 flushes


def phase_flush(record):
    """Batched ring writes (ring_flush = W) at the dense serve config: K6's
    W-row store against ring_store_plain(rows=W) bit for bit; a start that
    wraps, with no byte outside the ring; a 32-step chunk at batch 64 with
    ring_flush = 8 against the plain kernels and against ring_flush = 0;
    the chunk's time against ring_flush = 0."""
    import dataclasses
    import torch
    from fp8tpu_torch.kernels import inplace, qmatmul
    from fp8tpu_torch.serve import RingKVCache, ServeConfig, random_serve_params
    from fp8tpu_torch.serve import model as smodel
    from fp8tpu_torch.tools import device_ms

    cfg = serve_config()
    L, KV, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    params = STATE.get("e4m3")
    if params is None:
        params = STATE["e4m3"] = random_serve_params(cfg, "e4m3", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(30)
    result, problems = {}, []

    def raw(shape, dtype):
        n = 1
        for d in shape:
            n *= d
        size = torch.empty((), dtype=dtype).element_size()
        return torch.randint(0, 256, (n * size,), device="cuda",
                             dtype=torch.uint8, generator=gen
                             ).view(dtype).reshape(shape)

    # (a) W rows of both slabs at the served ring, 64 slots, bit for bit,
    # inside a storage with guard bytes on both sides of each ring.
    n = SERVE_SEQ
    bk = BENCH_BATCH * KV
    row8, rows_s = (2, L, bk, D), (2, L, bk)
    guard = 4096
    cases = bad = 0
    for dtype in (torch.int8, torch.float8_e4m3fn):
        store8 = raw((n * 2 * L * bk * D + 2 * guard,), torch.uint8)
        stores = raw((n * 2 * L * bk + 2 * guard // 4,), torch.float32)
        kv8 = store8[guard:-guard].view(dtype).reshape((n,) + row8)
        sc = stores[guard // 4:-(guard // 4)].reshape((n,) + rows_s)
        ref8, refs = store8.clone(), stores.clone()
        kv8_p = ref8[guard:-guard].view(dtype).reshape((n,) + row8)
        sc_p = refs[guard // 4:-(guard // 4)].reshape((n,) + rows_s)
        ticket = torch.zeros(1, device="cuda", dtype=torch.int32)
        for w in (2, 8, 16):
            for h0 in (0, w, n - w, n - 1, n + 3, -1):
                slab8, slabs = raw((w,) + row8, dtype), raw((w,) + rows_s,
                                                            torch.float32)
                head = torch.tensor(h0, device="cuda", dtype=torch.int32)
                head_p = head.clone()
                before = inplace.routes["ring_store"]
                inplace.ring_store(kv8, slab8, sc, slabs, head, n, ticket,
                                   rows=w)
                inplace.ring_store_plain(kv8_p, slab8, sc_p, slabs, head_p,
                                         n, rows=w)
                cases += 1
                launched = inplace.routes["ring_store"] == before + 1
                same = (torch.equal(store8, ref8)
                        and torch.equal(stores.view(torch.int32),
                                        refs.view(torch.int32)))
                if not (launched and same and int(ticket) == 0
                        and int(head) == int(head_p) == (h0 + w) % n):
                    bad += 1
                    print(f"  flush FAIL {str(dtype)[6:]} W={w} head={h0}: "
                          f"one launch {launched}, bytes equal {same}, head "
                          f"{int(head)} (plain {int(head_p)}), ticket "
                          f"{int(ticket)}")
        del store8, stores, ref8, refs
    print(f"flush (a): K6's W-row store at the served ring ({n} rows, "
          f"{BENCH_BATCH} slots, int8 and e4m3), W in 2, 8, 16, heads 0, W, "
          f"n - W and the wrapping n - 1, n + 3, -1: {cases} cases, {bad} "
          f"failed (both slabs and the guard bytes around the ring bit-equal "
          f"to ring_store_plain(rows=W), head advanced by W, ticket back at "
          f"0)")
    if bad:
        problems.append(f"K6's W-row store: {bad} of {cases} cases differ "
                        "from plain")
    result["a"] = {"cases": cases, "failed": bad}

    # (b) a 32-step chunk at batch 64, position 440 (W-aligned) of a warm
    # ring: ring_flush = 8 with the kernels (counted); the same steps with
    # the plain kernels and with ring_flush = 0, both fed the counted run's
    # greedy tokens (as serve (b) feeds its steps), for logits and ring
    # bytes; and ring_flush = 0 on its own greedy tokens, for the margin
    # rule.
    fcfg = ServeConfig(model=cfg, weight_fmt="e4m3", kv_fmt="int8",
                       ring_flush=FLUSH_W)
    zcfg = dataclasses.replace(fcfg, ring_flush=0)
    start = BENCH_WARM_POS - BENCH_WARM_POS % FLUSH_W
    ring0 = RingKVCache.create(L, BENCH_BATCH, BENCH_CACHE, KV, D, "int8")
    ring0.kv8.copy_(torch.randint(-127, 128, ring0.kv8.shape, device="cuda",
                                  generator=gen, dtype=torch.int8))
    ring0.sc.uniform_(0.004, 0.02, generator=gen)
    ring0.head.fill_(start)
    toks0 = torch.randint(1, cfg.vocab_size, (BENCH_BATCH,), device="cuda",
                          generator=gen, dtype=torch.int32)
    pos0 = torch.full((BENCH_BATCH,), start, device="cuda",
                      dtype=torch.int32)
    temp = torch.zeros(BENCH_BATCH, device="cuda")

    def clone(r):
        return RingKVCache(r.kv8.clone(), r.sc.clone(), r.head.clone())

    @torch.no_grad()
    def run(scfg, forced=None):
        """The chunk from ring0's state: (logits, tokens, ring); with
        ``forced`` (steps, B), step i's sampled tokens are forced[i]."""
        orig = smodel.sample_tokens
        if forced is not None:
            feed = iter(forced)
            smodel.sample_tokens = lambda *a, **kw: next(feed)
        try:
            (lg, tk), ring, _, _ = smodel._steps_impl(
                params, clone(ring0), toks0, pos0, None, temp, FLUSH_STEPS,
                scfg, True, greedy_only=True)
        finally:
            smodel.sample_tokens = orig
        return lg, tk, ring

    qmatmul.reset_launches()
    inplace.reset_launches()
    with _Counting(inplace, "ring_store_plain", forbid=True), \
            _Counting(qmatmul, "dequant_matmul_plain", forbid=True):
        lk, tk, rk = run(fcfg)
    torch.cuda.synchronize()
    flush_launches = {"ring_store": inplace.routes["ring_store"],
                      "dequant_matmul": qmatmul.dequant_launches}
    refs = {"plain": with_plain_kernels(lambda: run(fcfg, tk)),
            "ring_flush 0": run(zcfg, tk)}
    l0, t0_, r0 = run(zcfg)
    all_steps = torch.ones(FLUSH_STEPS, BENCH_BATCH, dtype=torch.bool,
                           device="cuda")
    checks = {}
    for what, (lb, _, rb) in refs.items():
        worst = float(((lk - lb).abs().amax(-1).amax(-1)
                       / lb.abs().amax(-1).amax(-1)).max())
        checks[what] = (worst,) + cache_checks(
            f"ring_flush chunk vs {what}", rk, rb, pos0, FLUSH_STEPS, KV,
            all_steps, start, whole_gate=False)
    # (The whole ring is not gated at 0.99 here: 32 of its 512 rows are
    # written, 26x serve (b)'s share, and the deep layers of those rows
    # differ by bf16 steps of the hidden state (layer 15 ~0.37 equal, as
    # the spec phase measures); the rows are gated layer by layer.)
    # the margin rule against ring_flush = 0's own greedy tokens: where a
    # slot's tokens part, ring_flush = 0's step is a near tie
    same = torch.cumprod((tk == t0_).to(torch.int32), 0).bool()
    parts = {}
    for b in (~same).any(0).nonzero().flatten().tolist():
        j = int((~same[:, b]).nonzero()[0])
        parts[b] = (j, near_tie(l0[j, b]))
    heads = (int(rk.head), int(refs["plain"][2].head),
             int(refs["ring_flush 0"][2].head), int(r0.head))
    worst_p, same_p = checks["plain"][0], checks["plain"][1]
    print(f"flush (b): {FLUSH_STEPS} greedy steps at batch {BENCH_BATCH} "
          f"from position {start}, ring_flush = {FLUSH_W}: ring_store "
          f"launches {flush_launches['ring_store']} (in place of "
          f"{FLUSH_STEPS}), K3 {flush_launches['dequant_matmul']}; fed its "
          f"tokens, the plain kernels: max|logit diff| / max|logit| "
          f"{worst_p:.3e} (tolerance {SERVE_LOGIT_TOL}), ring payload bytes "
          f"equal {same_p:.4f}, the rows the chunk wrote by layer: "
          f"{fmt_layers(checks['plain'][2])}; "
          f"ring_flush = 0: {checks['ring_flush 0'][0]:.3e}, ring bytes "
          f"equal {checks['ring_flush 0'][1]:.4f}, by layer "
          f"{fmt_layers(checks['ring_flush 0'][2])}; on its own greedy "
          f"tokens ring_flush = 0 parts from it in {len(parts)} of "
          f"{BENCH_BATCH} slots, all at near ties: "
          f"{all(t for _, t in parts.values())}; heads {heads}")
    if flush_launches["ring_store"] != FLUSH_STEPS // FLUSH_W:
        problems.append(f"{flush_launches['ring_store']} ring_store launches "
                        f"for {FLUSH_STEPS} steps at W = {FLUSH_W}")
    for what, (worst, _, _, bad) in checks.items():
        problems += bad
        if worst > SERVE_LOGIT_TOL:
            problems.append(f"ring_flush chunk vs {what}: logits {worst}")
    if not all(t for _, t in parts.values()):
        problems.append(f"tokens part from ring_flush = 0 off a near tie: "
                        f"{parts}")
    if len(set(heads)) != 1 or heads[0] != (start + FLUSH_STEPS) % n:
        problems.append(f"heads after the chunk {heads}")
    result["b"] = {"launches": flush_launches,
                   "checks": {k: v[:3] for k, v in checks.items()},
                   "parts_flush0": parts}
    del lk, l0, rk, r0, refs

    # (c) the chunk's time: ring_flush = 8 and 0 in turns, wall clock of
    # 32 steps and the device time of an 8-step chunk (one flush)
    def chunk(scfg, steps):
        ring = clone(ring0)
        return lambda: smodel.decode_steps(params, ring, toks0, pos0, None,
                                           temp, steps, scfg,
                                           greedy_only=True)[0]

    walls = {8: [], 0: []}
    for w in (8, 0):
        chunk({8: fcfg, 0: zcfg}[w], FLUSH_W)()
    torch.cuda.synchronize()
    for w in (8, 0, 0, 8):
        fn = chunk({8: fcfg, 0: zcfg}[w], FLUSH_STEPS)
        t = time.perf_counter()
        int(fn().sum())
        walls[w].append((time.perf_counter() - t) * 1e3)
    profs = {w: profile_decode_step(chunk({8: fcfg, 0: zcfg}[w], FLUSH_W),
                                    min(walls[w]) / FLUSH_STEPS, FLUSH_W)
             for w in (8, 0)}
    print(f"flush (c): {FLUSH_STEPS}-step chunk at batch {BENCH_BATCH}: "
          f"ring_flush = {FLUSH_W} {min(walls[8]):.2f} ms wall "
          f"({[round(x, 2) for x in walls[8]]}), ring_flush = 0 "
          f"{min(walls[0]):.2f} ms ({[round(x, 2) for x in walls[0]]}); "
          f"device ms a step over an {FLUSH_W}-step chunk (one flush): "
          f"{profs[8]['device_ms']:.3f} against {profs[0]['device_ms']:.3f}, "
          f"K6 {profs[8]['groups'].get('K6 ring store (hand-written)', (0.0, 0))[0]:.4f} "
          f"against {profs[0]['groups'].get('K6 ring store (hand-written)', (0.0, 0))[0]:.4f}")
    result["c"] = {"wall_ms": walls, "profile": profs}
    del ring0

    # the W-row store's own time at the timed ring, 64 slots
    kv8 = torch.zeros((n, 2, L, bk, D), dtype=torch.int8, device="cuda")
    sc = torch.ones((n, 2, L, bk), device="cuda")
    kv8_p, sc_p = kv8.clone(), sc.clone()
    slab8 = raw((FLUSH_W, 2, L, bk, D), torch.int8)
    slabs = torch.rand((FLUSH_W, 2, L, bk), device="cuda", generator=gen)
    head = torch.tensor(start, device="cuda", dtype=torch.int32)
    head_p = head.clone()
    ticket = torch.zeros(1, device="cuda", dtype=torch.int32)
    inplace.ring_store(kv8, slab8, sc, slabs, head, n, ticket, rows=FLUSH_W)
    inplace.ring_store_plain(kv8_p, slab8, sc_p, slabs, head_p, n,
                             rows=FLUSH_W)
    err = float(max((kv8.to(torch.int16) - kv8_p.to(torch.int16)).abs().max(),
                    (sc - sc_p).abs().max(), abs(int(head) - int(head_p))))
    t_k = device_ms(lambda: inplace.ring_store(kv8, slab8, sc, slabs, head, n,
                                               ticket, rows=FLUSH_W))
    t_p = device_ms(lambda: inplace.ring_store_plain(
        kv8_p, slab8, sc_p, slabs, head_p, n, rows=FLUSH_W))
    t_1 = device_ms(lambda: inplace.ring_store(kv8, slab8[0], sc, slabs[0],
                                               head, n, ticket))
    nbytes = slab8.numel() + 4 * slabs.numel()
    b = 2.0 * nbytes / HBM_BYTES_PER_S * 1e3
    print(f"time flush k6 W = {FLUSH_W} rows at {BENCH_BATCH} slots "
          f"({nbytes / 1e6:.2f} MB): ring_store {t_k:.5f} ms on the device, "
          f"plain {t_p:.5f} ms, bound {b:.5f} ms (bytes); one row "
          f"{t_1:.5f} ms ({FLUSH_W} of them {FLUSH_W * t_1:.5f})")
    if err:
        problems.append("the timed W-row store differs from plain")
    result["k6"] = {"ms": t_k, "plain_ms": t_p, "bound_ms": b,
                    "one_row_ms": t_1, "max_abs_err": err}
    record["flush"] = result
    del kv8, kv8_p, sc, sc_p
    torch.cuda.empty_cache()
    if problems:
        raise PhaseError("; ".join(problems))
    return [{"name": f"ring_store (W-row flush, ring_flush = {FLUSH_W})",
             "route": "cuda",
             "source": "fp8tpu_torch/kernels/csrc/inplace.cu",
             "replaces": "fp8tpu/kernels/inplace.py:27",
             "launches": flush_launches["ring_store"], "max_abs_err": err,
             "ms": t_k, "plain_ms": t_p, "bound_ms": b, "bound_by": "bytes",
             "library_ms": None}]


# -- phase 5 ----------------------------------------------------------------

def phase_time(record, batch: int, launches):
    import torch
    from fp8tpu_torch.kernels import cast_kernel, qmatmul
    from fp8tpu_torch.numerics.cast import qdq_plain
    from fp8tpu_torch.numerics.formats import RoundMode
    from fp8tpu_torch.numerics.scaling import per_tensor
    from fp8tpu_torch.tools import device_ms

    gen = torch.Generator(device="cuda").manual_seed(2)
    kernels = []

    # K1 at the largest residual_add operand, (batch, 256, 56, 56), held
    # bit-exact against the plain version on the CPU: device time by
    # CUDA-graph replay, and the eager call event-timed (the wrapper's host
    # time included).  Then all 32 operands of one forward's 16 residual
    # adds, summed against their bound.
    from fp8tpu_torch.tools.bench_k1k4 import residual_shapes
    x = torch.randn(batch, 256, 56, 56, device="cuda", generator=gen)
    s = per_tensor(x, "e4m3")
    want = qdq_plain(x.cpu(), "e4m3", RoundMode.RNE, s.cpu())
    got = cast_kernel.cuda_qdq(x, "e4m3", RoundMode.RNE, s).cpu()
    k1_bad = bits_equal(got, want)
    k1_err = float((got - want).abs().max())
    if k1_bad:
        raise PhaseError(f"K1 at {tuple(x.shape)}: {k1_bad} elements differ "
                         "from the plain version")
    k1_ms = device_ms(lambda: cast_kernel.cuda_qdq(x, "e4m3", RoundMode.RNE,
                                                   s))
    k1_eager = cuda_ms(lambda: cast_kernel.cuda_qdq(x, "e4m3", RoundMode.RNE,
                                                    s), iters=20, warmup=3)
    k1_plain = cuda_ms(lambda: qdq_plain(x, "e4m3", RoundMode.RNE, s),
                       iters=3, warmup=1)
    k1_bound = 8.0 * x.numel() / HBM_BYTES_PER_S * 1e3
    del x
    res_ms, res_elems = 0.0, 0
    for shape in residual_shapes(batch):
        xr = torch.randn(shape, device="cuda", generator=gen)
        sr = per_tensor(xr, "e4m3")
        res_ms += device_ms(lambda: cast_kernel.cuda_qdq(xr, "e4m3",
                                                         RoundMode.RNE, sr))
        res_elems += xr.numel()
        del xr
    res_bound = 8.0 * res_elems / HBM_BYTES_PER_S * 1e3
    print(f"time k1 cast e4m3 per-tensor ({batch}, 256, 56, 56): kernel "
          f"{k1_ms:.4f} ms on the device ({k1_eager:.4f} ms event-timed, the "
          f"wrapper included), plain {k1_plain:.4f} ms, bound {k1_bound:.4f} "
          f"ms (bytes), no PyTorch call computes this bit-exact cast; the 32 "
          f"residual-add operands of one forward ({res_elems / 1e6:.1f} M "
          f"elements): {res_ms:.4f} ms against {res_bound:.4f} ms")
    record["time_k1"] = {"ms": k1_ms, "event_timed_ms": k1_eager,
                         "plain_ms": k1_plain, "bound_ms": k1_bound,
                         "residual_ms": res_ms, "residual_bound_ms": res_bound,
                         "residual_elements": res_elems}
    kernels.append({
        "name": "cast_kernel", "route": "cuda",
        "source": "fp8tpu_torch/kernels/csrc/cast_kernel.cu",
        "replaces": "fp8tpu/kernels/cast_kernel.py:45",
        "launches": launches["cast_kernel"], "max_abs_err": k1_err,
        "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
        "bound_by": "bytes", "library_ms": None,
    })

    rows = [time_k2_conv(gen, name, conv, "bitexact")
            for name, conv in K2_CONVS]
    # K2 over all 52 patched convs of one forward: pre-passes and GEMM,
    # device time.
    total = 0.0
    for conv in resnet50_convs(batch):
        bb, cin, h, cout, k, st, pad = conv
        xx = torch.randn(bb, cin, h, h, device="cuda", generator=gen).relu_()
        w = torch.randn(cout, cin, k, k, device="cuda",
                        generator=gen) / (cin * k * k) ** 0.5
        pads = ((pad, pad), (pad, pad))
        sx = per_tensor(qmatmul.gathered(xx, (k, k), (st, st), pads), "e4m3")
        total += device_ms(lambda: qmatmul.conv(
            xx, w, (st, st), pads, "e4m3", RoundMode.RNE, sx))
        del xx, w
    flops = sum(2.0 * m * n * k for m, k, n in resnet50_conv_gemms(batch))
    simt, mma = flops / F32_SIMT_FLOPS * 1e3, 3 * flops / BF16_TC_FLOPS * 1e3
    print(f"time k2 all 52 convs of one forward: {total:.3f} ms "
          f"({flops / total / 1e9:.2f} TFLOP/s; bounds: f32 SIMT "
          f"{simt:.3f} ms, 3 bf16 MMAs {mma:.3f} ms)")
    record["time"] = {"k2_shapes": rows, "k2_forward_ms": total,
                      "k2_forward_bound_ms": simt,
                      "k2_forward_mma_bound_ms": mma}
    head = rows[0]
    entry = {"route": "cuda", "source": "fp8tpu_torch/kernels/csrc/qmatmul.cu",
             "replaces": "fp8tpu/kernels/qmatmul.py:193"}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels.append({"name": "qdq_matmul (PTQ, bitexact; pre-passes and "
                            "GEMM)", **entry,
                    "launches": launches["qdq_matmul"],
                    **{k: head[k] for k in keys}})
    kernels.append({"name": "qdq_matmul pre-pass (activation cast to bf16 "
                            "grid planes)", **entry,
                    "launches": launches["qdq_matmul_prepass"],
                    **{k: head["prepass"][k] for k in keys}})
    return kernels


def time_k2_conv(gen, name, conv, impl):
    """K2 as the engine conv (qmatmul.conv, the implicit GEMM with its two
    pre-passes), device time by CUDA-graph replay, beside its bounds (the
    larger of the bytes over HBM and its 3 bf16 MMAs a product at the
    dense bf16 rate; the f32 FMAs at the SIMT rate for reference), the
    plain version and two yardsticks used nowhere in the port: f32
    ``torch.matmul`` on the cast im2col and f32 ``F.conv2d`` (TF32 off) on
    the cast activation.  The activation's pre-pass alone is timed too."""
    import torch
    import torch.nn.functional as F
    from fp8tpu_torch._device import full_fp32
    from fp8tpu_torch.kernels import qmatmul
    from fp8tpu_torch.numerics.formats import RoundMode
    from fp8tpu_torch.numerics.scaling import per_tensor
    from fp8tpu_torch.tools import device_ms
    b, cin, h, cout, k, s, p = conv
    m, kk, n = conv_gemm(conv)
    x = torch.randn(b, cin, h, h, device="cuda", generator=gen).relu_()
    w = torch.randn(cout, cin, k, k, device="cuda",
                    generator=gen) / (cin * k * k) ** 0.5
    strides, pads = (s, s), ((p, p), (p, p))
    sx = per_tensor(qmatmul.gathered(x, (k, k), strides, pads), "e4m3")
    args = (x, w, strides, pads, "e4m3", RoundMode.RNE, sx, 0, impl)
    got = qmatmul.conv(*args)
    err = float((got - qmatmul.conv_plain(*args)).abs().max())
    colq, w2d = k2_conv_operands(*args)
    xq = qmatmul.cast_operand(x, "e4m3", RoundMode.RNE, sx, impl, None)

    def library():
        with full_fp32():
            return torch.matmul(colq, w2d)

    def cudnn():
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            return F.conv2d(xq, w, stride=s, padding=p)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32

    t_k = device_ms(lambda: qmatmul.conv(*args))
    t_p = cuda_ms(lambda: qmatmul.conv_plain(*args), iters=3, warmup=1)
    t_l, t_c = device_ms(library), device_ms(cudnn)
    t_bytes = 4.0 * (x.numel() + w.numel() + got.numel()) / HBM_BYTES_PER_S \
        * 1e3
    flops = 2.0 * m * n * kk
    t_simt = flops / F32_SIMT_FLOPS * 1e3
    t_mma = 3 * flops / BF16_TC_FLOPS * 1e3
    # the activation's pre-pass alone: its plain version is the plain
    # grid cast and the bf16 split
    t_pre = device_ms(lambda: qmatmul.conv_prepass(x, "e4m3", RoundMode.RNE,
                                                   sx, impl))
    t_pre_plain = cuda_ms(lambda: qmatmul.split_bf16(qmatmul.grid_operand(
        x, "e4m3", RoundMode.RNE, sx, impl, None)), iters=3, warmup=1)
    pre_got = qmatmul.conv_prepass(x, "e4m3", RoundMode.RNE, sx, impl)[0]
    pre_want = qmatmul.grid_operand(x, "e4m3", RoundMode.RNE, sx, impl,
                                    None).permute(0, 2, 3, 1).reshape(
                                        -1, cin).to(torch.bfloat16)
    pre_err = float((pre_got[:, :cin].float() - pre_want.float()).abs().max())
    pre_bytes = 6.0 * x.numel() / HBM_BYTES_PER_S * 1e3
    row = {"shape": name, "impl": impl, "m": m, "k": kk, "n": n, "ms": t_k,
           "plain_ms": t_p, "library_ms": t_l, "cudnn_conv_ms": t_c,
           "bound_ms": max(t_bytes, t_mma),
           "bound_by": "operations" if t_mma >= t_bytes else "bytes",
           "simt_f32_bound_ms": t_simt, "mma_bf16_bound_ms": t_mma,
           "bytes_bound_ms": t_bytes, "max_abs_err": err,
           "tflops": flops / t_k / 1e9,
           "prepass": {"ms": t_pre, "plain_ms": t_pre_plain,
                       "bound_ms": pre_bytes, "bound_by": "bytes",
                       "library_ms": None, "max_abs_err": pre_err}}
    print(f"time k2 {name} {impl} conv M={m} K={kk} N={n}: kernel "
          f"{t_k:.4f} ms ({flops / t_k / 1e9:.2f} TFLOP/s; pre-pass "
          f"{t_pre:.4f} ms against {pre_bytes:.4f} bytes), plain {t_p:.4f} "
          f"ms, bounds: 3 bf16 MMAs {t_mma:.4f}, bytes {t_bytes:.4f}, f32 "
          f"SIMT {t_simt:.4f} ms; yardsticks: f32 torch.matmul on the cast "
          f"im2col {t_l:.4f} ms, f32 F.conv2d (TF32 off) {t_c:.4f} ms")
    return row


def phase_time_train(record, launches):
    """K2's training variants at ResNet-50's first-stage 3x3 conv, batch 32:
    the "hw" e4m3 forward (the implicit conv), the backward's dX (g @ the
    weight's rows) and dW (the im2col read transposed in place, @ g; also
    unsplit, the kernel before split-K).  Device times by CUDA-graph
    replay; the bound is the larger of the bytes over HBM and the bf16
    MMAs (3 a product forward, 6 backward) at the dense bf16 rate; the
    yardstick is ``torch.matmul`` in f32 with TF32 off on the same
    operands."""
    import torch
    from fp8tpu_torch._device import full_fp32
    from fp8tpu_torch.kernels import qmatmul
    from fp8tpu_torch.numerics.formats import RoundMode
    from fp8tpu_torch.tools import device_ms

    gen = torch.Generator(device="cuda").manual_seed(6)
    rne = RoundMode.RNE
    rows = [time_k2_conv(gen, "stage0 3x3", K2_CONVS[0][1], "hw")]
    rows[0]["shape"] = "stage0 3x3 forward (hw)"
    m, kc, cout = K2_TRAIN_SHAPES["forward"]
    g = torch.randn(m, cout, device="cuda", generator=gen)
    w_rows = torch.randn(cout, kc, device="cuda", generator=gen) / kc ** 0.5
    colq = torch.randn(m, kc, device="cuda", generator=gen).relu_()
    for what, a, b, unsplit in (("dX", g, w_rows, False),
                                ("dW", colq.t(), g, False),
                                ("dW", colq.t(), g, True)):
        mm, kk, nn = a.shape[0], a.shape[1], b.shape[1]
        args = (a, b, None, rne, None, rne, 1.0, 1.0, 0)

        def kern():
            return qmatmul._launch(*args, unsplit=unsplit)

        def library():
            with full_fp32():
                return torch.matmul(a, b)

        err = float((kern() - qmatmul.plain(*args)).abs().max())
        t_k = device_ms(kern)
        t_p = cuda_ms(lambda: qmatmul.plain(*args), iters=3, warmup=1)
        t_l = device_ms(library)
        t_bytes = 4.0 * (a.numel() + b.numel() + mm * nn) / HBM_BYTES_PER_S \
            * 1e3
        flops = 2.0 * mm * nn * kk
        t_mma = 6 * flops / BF16_TC_FLOPS * 1e3
        used = qmatmul.k2_split(mm, nn, kk, qmatmul.sm_count(0), unsplit)[0]
        label = f"stage0 3x3 {what}" + (" unsplit" if unsplit else "")
        rows.append({"shape": label, "m": mm, "k": kk, "n": nn,
                     "splits": used, "ms": t_k, "plain_ms": t_p,
                     "library_ms": t_l, "bound_ms": max(t_bytes, t_mma),
                     "bound_by": "operations" if t_mma >= t_bytes
                     else "bytes",
                     "simt_f32_bound_ms": flops / F32_SIMT_FLOPS * 1e3,
                     "mma_bf16_bound_ms": t_mma, "bytes_bound_ms": t_bytes,
                     "max_abs_err": err, "tflops": flops / t_k / 1e9})
        print(f"time k2 {label} M={mm} K={kk} N={nn} ({used} K splits): "
              f"kernel {t_k:.4f} ms ({flops / t_k / 1e9:.2f} TFLOP/s), "
              f"plain {t_p:.4f} ms, bounds: bytes {t_bytes:.4f}, 6 bf16 "
              f"MMAs {t_mma:.4f}, f32 SIMT "
              f"{flops / F32_SIMT_FLOPS * 1e3:.4f} ms; f32 torch.matmul "
              f"{t_l:.4f} ms")
    record.setdefault("time", {})["k2_train_shapes"] = rows
    entry = {"route": "cuda", "source": "fp8tpu_torch/kernels/csrc/qmatmul.cu",
             "replaces": "fp8tpu/kernels/qmatmul.py:193"}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return [
        {"name": "qdq_matmul (hw route, training forward; pre-passes and "
                 "GEMM)", **entry,
         "launches": launches["qdq_matmul_hw"],
         **{k: rows[0][k] for k in keys}},
        {"name": "qdq_matmul (uncast, training backward dX and dW; times "
                 "at dW)", **entry,
         "launches": launches["qdq_matmul_uncast"],
         **{k: rows[2][k] for k in keys}},
    ]


def phase_time_serve(record, launches):
    """K3, K5 and K6 at the serving path's shapes: kernel, plain version,
    bound and a PyTorch yardstick.  Kernel and yardstick times are device
    times (device_ms); the plain versions are timed eagerly.  Weights rotate
    over the layers of the artifact (16 x 45 MB for the e4m3 gate
    projection, 4 x 22.5 MB for the int4 one), so a launch finds its
    weights in device memory, not in the 50 MB L2."""
    import torch
    from fp8tpu_torch.kernels import inplace, int4_matmul, qmatmul
    from fp8tpu_torch.tools import device_ms

    params, params4 = STATE["e4m3"], STATE["int4"]
    gen = torch.Generator(device="cuda").manual_seed(4)
    names = {"q8": "q/o 4096x4096", "k8": "k/v 4096x1024",
             "gate8": "gate/up 4096x11008", "down8": "down 11008x4096"}
    rows, kernels = [], []

    def rotating(fn, stack):
        state = {"i": 0}

        def call():
            state["i"] = (state["i"] + 1) % stack.shape[0]
            return fn(stack[state["i"]])
        return call

    def bound(m, k, n, w_bytes, extra=0.0):
        t_bytes = (2.0 * m * k + w_bytes + extra + 2.0 * m * n) \
            / HBM_BYTES_PER_S * 1e3
        t_ops = 2.0 * m * n * k / BF16_TC_FLOPS * 1e3
        return max(t_bytes, t_ops), \
            "operations" if t_ops > t_bytes else "bytes"

    for key, label in names.items():
        w_stack, s_stack = params[key], params[key[:-1] + "s"]
        k, n = w_stack.shape[1:]
        w_bf16 = w_stack[:4].to(torch.bfloat16)          # pre-converted
        for m in (SERVE_SLOTS, BENCH_BATCH, 512, PREFILL_ROWS):
            x = torch.randn(m, k, device="cuda", generator=gen
                            ).to(torch.bfloat16)
            s = s_stack[0]
            got = qmatmul.dequant_matmul(x, w_stack[0], s)
            want = qmatmul.dequant_matmul_plain(x, w_stack[0], s)
            err = float((got.float() - want.float()).abs().max())
            t_k = device_ms(rotating(
                lambda w: qmatmul.dequant_matmul(x, w, s), w_stack))
            t_call = cuda_ms(rotating(
                lambda w: qmatmul.dequant_matmul(x, w, s), w_stack), iters=32)
            t_p = cuda_ms(rotating(
                lambda w: qmatmul.dequant_matmul_plain(x, w, s), w_stack),
                iters=4, warmup=1)
            t_conv = device_ms(rotating(
                lambda w: torch.matmul(x, w.to(torch.bfloat16)) * s, w_stack))
            t_pre = device_ms(rotating(lambda w: torch.matmul(x, w), w_bf16))
            b, by = bound(m, k, n, float(k) * n, 4.0 * n)
            rows.append({"kernel": "K3", "shape": label, "m": m, "k": k,
                         "n": n, "ms": t_k, "eager_call_ms": t_call,
                         "plain_ms": t_p, "bound_ms": b,
                         "bound_by": by, "library_convert_ms": t_conv,
                         "library_bf16_ms": t_pre, "max_abs_err": err,
                         "gb_per_s": (k * n) / t_k / 1e6})
            print(f"time k3 {label} M={m}: kernel {t_k:.4f} ms on the device "
                  f"({k * n / t_k / 1e6:.0f} GB/s of payload; {t_call:.4f} "
                  f"ms per eager call, host included), plain "
                  f"{t_p:.4f} ms, bound {b:.4f} ms ({by}), (x @ "
                  f"w8.to(bf16)) * s {t_conv:.4f} ms, torch.matmul on a "
                  f"bf16 weight {t_pre:.4f} ms")
    head = next(r for r in rows if r["shape"].startswith("gate")
                and r["m"] == SERVE_SLOTS)
    kernels.append({
        "name": "dequant_matmul", "route": "cuda",
        "source": "fp8tpu_torch/kernels/csrc/dequant_matmul.cu",
        "replaces": "fp8tpu/kernels/qmatmul.py:87",
        "launches": launches["dequant_matmul"],
        "max_abs_err": head["max_abs_err"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_convert_ms"]})
    pre = next(r for r in rows if r["shape"].startswith("gate")
               and r["m"] == PREFILL_ROWS)
    kernels.append({
        "name": "dequant_matmul_prefill", "route": "cuda",
        "source": "fp8tpu_torch/kernels/csrc/w_stream.cuh",
        "replaces": "fp8tpu/kernels/qmatmul.py:87",
        "launches": launches["dequant_matmul_prefill"],
        "max_abs_err": pre["max_abs_err"], "ms": pre["ms"],
        "plain_ms": pre["plain_ms"], "bound_ms": pre["bound_ms"],
        "bound_by": pre["bound_by"],
        "library_ms": pre["library_convert_ms"]})

    rows5 = []
    for key, label in names.items():
        w_stack, s_stack = params4[key], params4[key[:-1] + "s"]
        k, n = 2 * w_stack.shape[1], w_stack.shape[2]
        group = k // s_stack.shape[1]
        lo, hi = int4_matmul.unpack_int4(w_stack)
        w_bf16 = torch.stack([lo, hi], 2).reshape(-1, k, n).to(torch.bfloat16)
        del lo, hi
        for m in (SERVE_SLOTS, BENCH_BATCH, 512, PREFILL_ROWS):
            x = torch.randn(m, k, device="cuda", generator=gen
                            ).to(torch.bfloat16)
            s = s_stack[0]
            got = int4_matmul.int4_matmul(x, w_stack[0], s, group)
            want = int4_matmul.int4_matmul_plain(x, w_stack[0], s, group)
            err = float((got.float() - want.float()).abs().max())
            t_k = device_ms(rotating(
                lambda w: int4_matmul.int4_matmul(x, w, s, group), w_stack))
            t_p = cuda_ms(rotating(
                lambda w: int4_matmul.int4_matmul_plain(x, w, s, group),
                w_stack), iters=4, warmup=1)
            t_pre = device_ms(rotating(lambda w: torch.matmul(x, w), w_bf16))
            b, by = bound(m, k, n, k * n / 2.0, 4.0 * s.numel())
            rows5.append({"kernel": "K5", "shape": label, "m": m, "k": k,
                          "n": n, "group": group, "ms": t_k, "plain_ms": t_p,
                          "bound_ms": b, "bound_by": by,
                          "library_bf16_ms": t_pre, "max_abs_err": err})
            print(f"time k5 {label} group {group} M={m}: kernel {t_k:.4f} "
                  f"ms on the device ({k * n / 2 / t_k / 1e6:.0f} GB/s of "
                  f"payload), plain "
                  f"{t_p:.4f} ms, bound {b:.4f} ms ({by}), torch.matmul on "
                  f"a pre-unpacked bf16 weight {t_pre:.4f} ms")
        del w_bf16
    head5 = next(r for r in rows5 if r["shape"].startswith("gate")
                 and r["m"] == SERVE_SLOTS)
    kernels.append({
        "name": "int4_matmul", "route": "cuda",
        "source": "fp8tpu_torch/kernels/csrc/int4_matmul.cu",
        "replaces": "fp8tpu/kernels/int4_matmul.py:57",
        "launches": launches["int4_matmul"],
        "max_abs_err": head5["max_abs_err"], "ms": head5["ms"],
        "plain_ms": head5["plain_ms"], "bound_ms": head5["bound_ms"],
        "bound_by": head5["bound_by"],
        "library_ms": head5["library_bf16_ms"]})
    pre5 = next(r for r in rows5 if r["shape"].startswith("gate")
                and r["m"] == PREFILL_ROWS)
    kernels.append({
        "name": "int4_matmul_prefill", "route": "cuda",
        "source": "fp8tpu_torch/kernels/csrc/w_stream.cuh",
        "replaces": "fp8tpu/kernels/int4_matmul.py:57",
        "launches": launches["int4_matmul_prefill"],
        "max_abs_err": pre5["max_abs_err"], "ms": pre5["ms"],
        "plain_ms": pre5["plain_ms"], "bound_ms": pre5["bound_ms"],
        "bound_by": pre5["bound_by"],
        "library_ms": pre5["library_bf16_ms"]})

    rows6 = []
    cfg = serve_config()
    for label, batch in (("served engine", SERVE_SLOTS),
                         ("timed decode", BENCH_BATCH)):
        bk = batch * cfg.n_kv_heads
        for what, shape, dtype in (
                ("payload", (2, cfg.n_layers, bk, cfg.head_dim), torch.int8),
                ("scales", (2, cfg.n_layers, bk), torch.float32)):
            buf = torch.zeros((SERVE_SEQ,) + shape, dtype=dtype,
                              device="cuda")
            ref = buf.clone()
            slab = torch.randint(-100, 100, shape, device="cuda",
                                 generator=gen).to(dtype)
            idx = torch.tensor(SERVE_SEQ + 5, device="cuda",
                               dtype=torch.int32)
            row = torch.tensor([5], device="cuda")
            inplace.dyn_store(buf, slab, idx)
            inplace.dyn_store_plain(ref, slab, idx)
            err = float((buf.float() - ref.float()).abs().max())
            t_k = device_ms(lambda: inplace.dyn_store(buf, slab, idx))
            t_p = device_ms(lambda: inplace.dyn_store_plain(ref, slab, idx))
            t_l = device_ms(lambda: buf.index_copy_(0, row, slab[None]))
            nbytes = slab.numel() * slab.element_size()
            b = 2.0 * nbytes / HBM_BYTES_PER_S * 1e3
            rows6.append({"kernel": "K6", "what": f"{label} {what}",
                          "bytes": nbytes, "ms": t_k, "plain_ms": t_p,
                          "bound_ms": b, "bound_by": "bytes",
                          "library_ms": t_l, "max_abs_err": err})
            print(f"time k6 {label} {what} slab {shape} "
                  f"{str(dtype)[6:]} ({nbytes} bytes): kernel {t_k:.5f} ms on "
                  f"the device, plain {t_p:.5f} ms, bound {b:.5f} ms "
                  f"(bytes), index_copy_ {t_l:.5f} ms")
            if err:
                raise PhaseError(f"K6 {label} {what}: differs from plain")
    head6 = rows6[0]
    kernels.append({
        "name": "dyn_store", "route": "cuda",
        "source": "fp8tpu_torch/kernels/csrc/inplace.cu",
        "replaces": "fp8tpu/kernels/inplace.py:27",
        "launches": launches["dyn_store"],
        "max_abs_err": head6["max_abs_err"], "ms": head6["ms"],
        "plain_ms": head6["plain_ms"], "bound_ms": head6["bound_ms"],
        "bound_by": "bytes", "library_ms": head6["library_ms"]})
    ring6 = time_ring_write(gen)
    head_r = ring6[0]
    kernels.append({
        "name": "ring_store", "route": "cuda",
        "source": "fp8tpu_torch/kernels/csrc/inplace.cu",
        "replaces": "fp8tpu/kernels/inplace.py:27",
        "launches": launches["ring_store"],
        "max_abs_err": head_r["max_abs_err"], "ms": head_r["ms"],
        "plain_ms": head_r["plain_ms"], "bound_ms": head_r["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "launch_floor_ms": head_r["empty_launch_ms"]})
    record.setdefault("time", {}).update(
        {"k3_shapes": rows, "k5_shapes": rows5, "k6_shapes": rows6,
         "k6_ring_write": ring6})
    return kernels


def time_ring_write(gen):
    """One decode step's ring write at the served (8-slot) and timed
    (64-slot) ring: ring_store, its plain version, the four launches it
    replaced (two dyn_store and the head's add and remainder), an empty
    kernel's launch, all by CUDA-graph replay, and the byte bound; the
    kernel's bytes and head against the plain version's."""
    import torch
    from fp8tpu_torch.kernels import inplace
    from fp8tpu_torch.tools import bench_t1k6, device_ms

    lib, _ = bench_t1k6.build_probe(os.path.dirname(os.path.abspath(
        __file__)))
    empty = bench_t1k6.empty_launch_ms(lib)
    rows = []
    for label, slots in (("served engine", SERVE_SLOTS),
                         ("timed decode", BENCH_BATCH)):
        kv8, slab8, sc, slabs = bench_t1k6.ring_slabs(gen, slots)
        kv8_p, sc_p = kv8.clone(), sc.clone()
        n = kv8.shape[0]
        head = torch.tensor(n + 5, device="cuda", dtype=torch.int32)
        head_p, ticket = head.clone(), torch.zeros(
            1, device="cuda", dtype=torch.int32)
        inplace.ring_store(kv8, slab8, sc, slabs, head, n, ticket)
        inplace.ring_store_plain(kv8_p, slab8, sc_p, slabs, head_p, n)
        err = max(float((kv8.to(torch.int16) - kv8_p.to(torch.int16)
                         ).abs().max()),
                  float((sc - sc_p).abs().max()),
                  float(abs(int(head) - int(head_p))))
        t_k = device_ms(lambda: inplace.ring_store(kv8, slab8, sc, slabs,
                                                   head, n, ticket))
        t_p = device_ms(lambda: inplace.ring_store_plain(
            kv8_p, slab8, sc_p, slabs, head_p, n))
        state = {"head": head_p.clone()}

        def four():
            inplace.dyn_store(kv8, slab8, state["head"])
            inplace.dyn_store(sc, slabs, state["head"])
            state["head"] = torch.remainder(state["head"] + 1, n)
        t_4 = device_ms(four)
        b = bench_t1k6.ring_write_bound_ms(slots)
        rows.append({"kernel": "K6 ring_store", "what": label,
                     "slots": slots, "ms": t_k, "plain_ms": t_p,
                     "four_launches_ms": t_4, "empty_launch_ms": empty,
                     "bound_ms": b, "bound_by": "bytes",
                     "max_abs_err": err})
        print(f"time k6 ring write, {label} ({slots} slots): ring_store "
              f"{t_k:.5f} ms on the device, plain {t_p:.5f} ms, 2 x "
              f"dyn_store + head ops {t_4:.5f} ms, an empty launch "
              f"{empty:.5f} ms, bound {b:.5f} ms (bytes)")
        if err:
            raise PhaseError(f"K6 ring_store {label}: differs from plain")
        del kv8, kv8_p, sc, sc_p
    return rows


def phase_time_paged(record, launches):
    """K4 at the paged path's shapes (8 slots and 64, position 444 of a
    512-token pool, one layer a launch): device time by CUDA-graph replay
    over the 16 layers of the pool in turn (16 x 8.6 MB of one layer's
    mapped pages at 8 slots, so a launch finds them in device memory, not
    in the L2), the plain version, the bound from this run's lengths, and a
    PyTorch yardstick: the same partials from ``torch.bmm`` on a gathered
    snapshot of the layer's pages upcast to bf16."""
    import torch
    from fp8tpu_torch.kernels import paged_attention as k4
    from fp8tpu_torch.tools import device_ms

    cfg = serve_config()
    L, KV, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    G = cfg.n_heads // KV
    mp = BENCH_CACHE // PAGE
    gen = torch.Generator(device="cuda").manual_seed(14)
    kw = dict(page_size=PAGE, kv_heads=KV)
    rows = []
    for label, batch in (("served engine", SERVE_SLOTS),
                         ("timed decode", BENCH_BATCH)):
        P = batch * mp
        pool = torch.randint(-127, 128, (P, 2, L, PAGE * KV, D),
                             device="cuda", generator=gen, dtype=torch.int8)
        sc = torch.empty((P, 2, L, PAGE * KV), device="cuda").uniform_(
            0.004, 0.02, generator=gen)
        table = torch.randperm(P, device="cuda", generator=gen
                               ).to(torch.int32).reshape(batch, mp)
        lens = torch.full((batch,), BENCH_WARM_POS, device="cuda",
                          dtype=torch.int32)
        q = (torch.randn(batch, KV * G, D, device="cuda", generator=gen)
             * 0.7).to(torch.bfloat16)
        layer = {"i": 0}

        def kern():
            layer["i"] = (layer["i"] + 1) % L
            return k4.paged_decode_attention(q, pool, sc, table, lens,
                                             layer["i"], **kw)

        def plain():
            return k4.paged_decode_attention_plain(q, pool, sc, table, lens,
                                                   3, **kw)

        safe = table.long()
        T = mp * PAGE
        mask = (torch.arange(T, device="cuda")[None] < lens[:, None]
                )[:, None, :].repeat_interleave(KV, 0)        # (B*KV, 1, T)

        def library():
            layer["i"] = (layer["i"] + 1) % L
            li = layer["i"]
            k = pool[safe, 0, li].to(torch.bfloat16).reshape(batch, T, KV, D)
            v = pool[safe, 1, li].to(torch.bfloat16).reshape(batch, T, KV, D)
            ks = sc[safe, 0, li].reshape(batch, T, KV).permute(0, 2, 1)
            vs = sc[safe, 1, li].reshape(batch, T, KV).permute(0, 2, 1)
            s = torch.bmm(q.reshape(batch * KV, G, D),
                          k.permute(0, 2, 3, 1).reshape(batch * KV, D, T),
                          out_dtype=torch.float32) \
                * ks.reshape(batch * KV, 1, T)
            s = torch.where(mask, s, -1e30)
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            pv = (p * vs.reshape(batch * KV, 1, T)).to(torch.bfloat16)
            acc = torch.bmm(pv, v.permute(0, 2, 1, 3).reshape(batch * KV, T,
                                                               D),
                            out_dtype=torch.float32)
            return acc, m, p.sum(-1)

        got = k4.paged_decode_attention(q, pool, sc, table, lens, 3, **kw)
        want = plain()
        err = float((got[0] - want[0]).abs().max())
        layer["i"] = 2                     # the next library() reads layer 3
        lib = library()
        lib_err = float((lib[0].reshape(batch, KV * G, D) - want[0]
                         ).abs().max())
        t_k = device_ms(kern)
        t_p = cuda_ms(plain, iters=3, warmup=1)
        t_l = device_ms(library)
        # each input read once, each output written once, for THIS run's
        # lengths: the valid tokens' K and V rows and scales of one head
        # vector each, the table, the lengths, q, and the three outputs
        tokens = int(lens.sum())
        nbytes = (tokens * KV * (2 * D + 2 * 4) + table.numel() * 4
                  + lens.numel() * 4 + q.numel() * 2
                  + batch * KV * G * (D + 2) * 4)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2.0 * 2 * tokens * KV * G * D / F32_SIMT_FLOPS * 1e3
        rows.append({"kernel": "K4", "what": label, "batch": batch,
                     "tokens": tokens, "bytes": nbytes, "ms": t_k,
                     "plain_ms": t_p, "library_ms": t_l,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "operations" if t_ops > t_bytes else "bytes",
                     "max_abs_err": err, "library_max_abs_err": lib_err,
                     "gb_per_s": nbytes / t_k / 1e6})
        print(f"time k4 {label}: {batch} slots x {BENCH_WARM_POS} tokens, "
              f"int8 pool, one layer: kernel {t_k:.5f} ms on the device "
              f"({nbytes / t_k / 1e6:.0f} GB/s of {nbytes / 1e6:.2f} MB), "
              f"plain {t_p:.4f} ms, bound {max(t_bytes, t_ops):.5f} ms "
              f"({rows[-1]['bound_by']}), gather + upcast + torch.bmm "
              f"{t_l:.5f} ms (max|acc diff| to plain {lib_err:.2e})")
        del pool, sc
    head = rows[0]
    record.setdefault("time", {})["k4_shapes"] = rows
    time_paged_prefill(record)
    return [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "fp8tpu_torch/kernels/csrc/paged_attention.cu",
        "replaces": "fp8tpu/kernels/paged_attention.py:55",
        "launches": launches["paged_decode_attention"],
        "max_abs_err": head["max_abs_err"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"]}]


def prefill_runner(params, scfg, seed: int):
    """``run()``: one paged prefill of SERVE_SLOTS prompts of PREFILL_TOKENS
    random tokens (``prefill_batch_paged``, PREFILL_ROWS rows a linear)
    into a fresh int8 pool that holds them exactly, the prompts made from
    ``seed``."""
    import torch
    from fp8tpu_torch.serve import PagedKVCache, prefill_batch_paged
    cfg = scfg.model
    B, T = SERVE_SLOTS, PREFILL_TOKENS
    gen = torch.Generator(device="cuda").manual_seed(seed)
    prompts = torch.randint(1, cfg.vocab_size, (B, T), device="cuda",
                            generator=gen, dtype=torch.int32)
    lengths = torch.full((B,), T, device="cuda", dtype=torch.int32)
    slots = torch.arange(B, device="cuda", dtype=torch.int32)
    zeros = torch.zeros(B, device="cuda")
    zi = torch.zeros(B, device="cuda", dtype=torch.int32)
    paged = PagedKVCache.create(B * T // PAGE, PAGE, cfg.n_layers, B, T // PAGE,
                                cfg.n_kv_heads, cfg.head_dim, "int8")
    paged.page_table = torch.arange(
        B * T // PAGE, device="cuda", dtype=torch.int32).reshape(B, -1)

    def run():
        return prefill_batch_paged(params, paged, prompts, slots, lengths,
                                   None, zeros, None, None, zi, zi.clone(),
                                   scfg)
    return run


def time_paged_prefill(record):
    """One paged prefill of 8 prompts of 256 tokens (prefill_batch_paged:
    2048 rows a linear, 112 K3 launches on the prefill route), e4m3 weights
    against the bf16 twin (its linears torch.mm on bf16 weights), both on
    an int8 pool: wall clock (best of 3, host included) and a
    torch.profiler breakdown of one call, K3's share of the device time.
    The profile must hold every K3 launch the wrappers counted."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    from fp8tpu_torch.serve import ServeConfig, random_serve_params

    cfg = serve_config()
    L = cfg.n_layers
    B, T = SERVE_SLOTS, PREFILL_TOKENS
    k3_group = "K3/K5 weight GEMM (hand-written)"
    result, problems = {}, []
    for fmt in ("e4m3", "bf16"):
        params = STATE["e4m3"] if fmt == "e4m3" else random_serve_params(
            cfg, "bf16", seed=0)
        scfg = ServeConfig(model=cfg, weight_fmt=fmt, kv_fmt="int8",
                           paged_decode_impl="kernel")
        run = prefill_runner(params, scfg, 15)
        run()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        best = min(times) * 1e3
        before = dict(qmatmul.dequant_routes)
        want = wrapper_counts(run)
        on_route = {k: qmatmul.dequant_routes[k] - before[k] for k in before}
        prof, attempt = counted_profile(run, best, want)
        k3_ms, k3_n = prof["groups"].get(k3_group, (0.0, 0))
        result[fmt] = {"wall_ms": best, "wall_ms_all": times,
                       "device_ms": prof["device_ms"], "k3_ms": k3_ms,
                       "k3_launches": k3_n, "k3_by_route": on_route,
                       "profile": prof, "profiles_taken": attempt}
        print(f"time prefill (paged, {B} x {T} tokens, {B * T} rows a "
              f"linear), {fmt} weights: {best:.3f} ms wall clock (best of "
              f"3), {prof['device_ms']:.3f} ms of kernels in "
              f"{prof['launches']} launches, busy share "
              f"{prof['busy_share']:.3f}; K3 {k3_ms:.3f} ms in {k3_n} "
              f"launches ({k3_ms / prof['device_ms']:.3f} of the device "
              f"time; by route {on_route}; profiles taken {attempt})")
        for group, (ms_, n_) in prof["groups"].items():
            print(f"    {ms_:8.3f} ms {n_:5d}x  {group}")
        if fmt == "e4m3" and (k3_n != 7 * L or on_route["prefill"] != 7 * L):
            problems.append(f"the paged prefill launched K3 {k3_n} times "
                            f"(by route {on_route}), expected {7 * L} on the "
                            "prefill route")
        del params, run
        torch.cuda.empty_cache()
    record.setdefault("time", {})["paged_prefill"] = result
    if problems:
        raise PhaseError("; ".join(problems))


def k4_launch_exactness(q, pool, sc, table, lens, layer, kv, page, got):
    """One K4 launch's outputs ``got`` (acc, m, l) against its plain version
    on the same operands: the shares of (slot, query head) whose m, l and
    whole acc row are bit-equal; the share of valid scores q . k whose f32
    sum (IEEE) differs from the f64 one; how the softmax sits (the share
    of heads whose largest weight is at least 0.999, and the median
    largest weight); the scores' f32 rounding bound (k4_reference's s_tol:
    2 D 2^-24 max_t sum_d |q_d k_td| ks_t, an absolute error of the score,
    so a relative one of every weight p = exp(s - m)), its median and
    largest; and the normalised context acc / l of the kernel and of the
    plain version against the f64 one, max|diff| over max|f64| per row,
    the worst row."""
    import torch
    from fp8tpu_torch._device import full_fp32
    from fp8tpu_torch.kernels import paged_attention as k4
    acc, m, l = got
    acc_p, m_p, l_p = k4.paged_decode_attention_plain(
        q, pool, sc, table, lens, layer, page_size=page, kv_heads=kv)
    _, _, _, s_tol, _, _ = k4_reference(q, pool, sc, table, lens, layer,
                                        kv=kv, page=page)
    B, KVG, D = q.shape
    T = table.shape[1] * page
    safe = table.clamp(min=0).long()
    k = pool[safe, 0, layer].reshape(B, T, kv, D).double()
    v = pool[safe, 1, layer].reshape(B, T, kv, D).double()
    ks = sc[safe, 0, layer].reshape(B, T, kv).permute(0, 2, 1)[:, :, None]
    vs = sc[safe, 1, layer].reshape(B, T, kv).permute(0, 2, 1)[:, :, None]
    qh = q.float().reshape(B, kv, KVG // kv, D)
    with full_fp32():
        s32 = torch.einsum("bkgd,btkd->bkgt", qh, k.float())
    s64 = torch.einsum("bkgd,btkd->bkgt", qh.double(), k)
    valid = (torch.arange(T, device=q.device)[None] < lens[:, None]
             )[:, None, None, :].expand_as(s64)
    w = torch.softmax(torch.where(valid, s64 * ks.double(), -math.inf), -1)
    ctx64 = torch.einsum("bkgt,btkd->bkgd", w * vs.double(), v
                         ).reshape(B, KVG, D)
    top = w.amax(-1).flatten()

    def off(a, b):
        c = (a.double() / b.double()[..., None])
        return float(((c - ctx64).abs().amax(-1)
                      / ctx64.abs().amax(-1).clamp_min(1e-30)).max())
    return {"m_equal": float((m == m_p).float().mean()),
            "l_equal": float((l == l_p).float().mean()),
            "acc_rows_equal": float((acc == acc_p).all(-1).float().mean()),
            "scores_inexact_in_f32": float((s32.double() != s64)[valid]
                                           .float().mean()),
            "peaked_heads": float((top >= 0.999).float().mean()),
            "median_top_weight": float(top.median()),
            "s_tol_median": float(s_tol.median()),
            "s_tol_max": float(s_tol.max()),
            "kernel_vs_f64": off(acc, l), "plain_vs_f64": off(acc_p, l_p)}


def phase_k4_layers(record):
    """Which kernel moves the deeper layers of a full-width paged decode
    step (64 slots, int8 pool, "kernel" mode), and why on one draw of
    weights and not on another.  One step with every kernel, with every
    plain version, with the kernels but K4's plain version, and with the
    plain versions but K4's kernel; for e4m3 weights direct and convert
    and int8 weights direct: each run's logit distance to the all-plain run
    and the rows it wrote, layer by layer (the first four).  Then the
    kernel run's K4 launches against their plain versions on their own
    operands (k4_launch_exactness): bit-equal shares, the scores' f32
    rounding, how peaked the softmax is, and both versions against f64;
    layer 0 and the least equal layer."""
    import torch
    from fp8tpu_torch.kernels import paged_attention as k4
    from fp8tpu_torch.serve import (PagedKVCache, ServeConfig,
                                    decode_step_paged, prefill_batch_paged,
                                    random_serve_params)

    cfg = serve_config()
    L, KV, D, B = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, BENCH_BATCH
    kernel = k4.paged_decode_attention
    result = {}

    def k4_plain(f):
        k4.paged_decode_attention = k4.paged_decode_attention_plain
        try:
            return f()
        finally:
            k4.paged_decode_attention = kernel

    for fmt, impl, seed in (("e4m3", "direct", 0), ("int8", "direct", 32),
                            ("e4m3", "convert", 0)):
        params = STATE["e4m3"] if fmt == "e4m3" and "e4m3" in STATE else \
            random_serve_params(cfg, fmt, seed=seed)
        scfg = ServeConfig(model=cfg, weight_fmt=fmt, kv_fmt="int8",
                           matmul_impl=impl, paged_decode_impl="kernel")
        g = torch.Generator(device="cuda").manual_seed(34)
        paged = PagedKVCache.create(B * 4, PAGE, L, B, 4, KV, D, "int8")
        paged.page_table = torch.randperm(
            B * 4, device="cuda", generator=g).to(torch.int32).reshape(B, 4)
        prompts = torch.randint(1, cfg.vocab_size, (B, 128), device="cuda",
                                generator=g, dtype=torch.int32)
        lengths = torch.randint(70, 129, (B,), device="cuda", generator=g,
                                dtype=torch.int32)
        zi = torch.zeros(B, device="cuda", dtype=torch.int32)
        _, paged, toks, pos = prefill_batch_paged(
            params, paged, prompts, torch.arange(B, device="cuda",
                                                 dtype=torch.int32),
            lengths, None, torch.zeros(B, device="cuda"), None, None, zi,
            zi.clone(), scfg)
        runs = {}
        for name, wrap in (("kernels", lambda f: f()),
                           ("plain", with_plain_kernels),
                           ("kernels, K4 plain", k4_plain),
                           ("plain, K4 kernel", with_plain_but_k4)):
            st = clone_pool(paged)
            with _Recording(k4, "paged_decode_attention") as rec:
                runs[name] = wrap(lambda: decode_step_paged(params, st, toks,
                                                            pos, scfg))
            if name == "kernels":
                launches = rec.calls
        live = torch.ones(1, B, dtype=torch.bool, device="cuda")
        lp, sp = runs["plain"]
        entry = {}
        for name in ("kernels", "kernels, K4 plain", "plain, K4 kernel"):
            lg, st = runs[name]
            _, dist, _ = cache_checks(name, st, sp, pos, 1, KV, live,
                                      whole_gate=False)
            rel = rel_err(lg, lp)
            entry[name] = {"rel_logit_diff": rel, "layers": dist[:4]}
            print(f"k4_layers {fmt} {impl}, {name} vs plain: logits "
                  f"{rel:.3e}; {fmt_layers(dist[:4])}", flush=True)
        ex = [k4_launch_exactness(*a[:6], kw["kv_heads"], kw["page_size"],
                                  out) for a, kw, out in launches]
        worst = min(range(len(ex)), key=lambda i: ex[i]["acc_rows_equal"])
        entry["k4_launches"] = ex
        print(f"k4_layers {fmt} {impl}: K4 against plain on its own "
              f"operands, layer 0 {ex[0]}; least equal, layer {worst} "
              f"{ex[worst]}", flush=True)
        result[f"{fmt} {impl}"] = entry
        del params, paged, runs, launches
        torch.cuda.empty_cache()
    record["k4_layers"] = result


PROBE_TRIES = 8                # profiles a setting
LAUNCH_APIS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
               "cuLaunchKernelEx")


def phase_profile_probe(record):
    """Why a torch.profiler profile of the 8 x 256 paged prefill (e4m3, K3
    on its prefill route) can hold fewer kernel records than the wrappers
    launched.  Each profile's raw kineto events are read: the host's launch
    calls (cudaLaunchKernel and kin) are matched to the device records by
    correlation id, and a launch with no device record is listed by its
    place among the launches (the lead-in's excluded).  PROBE_TRIES
    profiles without the lead-in of ``open_profile`` and as many with it."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    from fp8tpu_torch.serve import ServeConfig, random_serve_params

    cfg = serve_config()
    if "e4m3" not in STATE:
        STATE["e4m3"] = random_serve_params(cfg, "e4m3", seed=0)
    scfg = ServeConfig(model=cfg, weight_fmt="e4m3", kv_fmt="int8",
                       paged_decode_impl="kernel")
    run = prefill_runner(STATE["e4m3"], scfg, 15)
    run()
    before = qmatmul.dequant_launches
    run()
    torch.cuda.synchronize()
    k3_want = qmatmul.dequant_launches - before
    cuda = torch.autograd.DeviceType.CUDA
    rows = []
    for lead in (False, True):
        for i in range(PROBE_TRIES):
            p = open_profile(run, lead)
            raw = list(p.profiler.kineto_results.events())
            kern = {e.correlation_id(): e for e in raw
                    if e.device_type() == cuda}
            calls = sorted((e for e in raw if e.name() in LAUNCH_APIS),
                           key=lambda e: e.start_ns())
            if lead:        # the lead-in's launches and what recorded them
                calls = calls[PROFILE_LEAD_LAUNCHES:]
            k3 = sum(kernel_kind(e.name()).startswith("K3")
                     for e in kern.values())
            missing = [j for j, e in enumerate(calls)
                       if e.correlation_id() not in kern]
            row = {"lead_in": lead, "try": i, "k3_records": k3,
                   "launch_calls": len(calls),
                   "device_records": len(kern),
                   "launches_without_record": missing}
            rows.append(row)
            print(f"profile_probe lead-in {lead}, profile {i}: K3 records "
                  f"{k3} of {k3_want}; {len(calls)} host launch calls of the "
                  f"work, {len(missing)} without a device record"
                  + (f" (launches {missing[0]}-{missing[-1]})" if missing
                     else ""), flush=True)
            del p, raw, kern, calls
    record["profile_probe"] = {"k3_launches": k3_want, "profiles": rows}
    bad = [r for r in rows if r["lead_in"] and r["launches_without_record"]]
    del run
    torch.cuda.empty_cache()
    if bad:
        raise PhaseError(f"{len(bad)} profiles with the lead-in lost device "
                         "records")


# -- phase sparse --------------------------------------------------------------

SPARSE_GATE = (4096, 11008)        # the serve config's gate weight, f32
SPARSE_GRAD = (8192, 4096)         # 32 x 256 tokens at d_model 4096
SPARSE_THRESHOLD_RTOL = 1e-5       # tests/test_torch_sparse.py's
SPARSE_LINEAR_TOKENS = 2048
# tests/test_native_ref.py's deterministic mode strings
NATIVE_MODES = (
    "E5M2_RNE", "E5M2_RTZ", "E5M2_RNAZ", "E5M2_RNTZ", "E5M2_RPINF",
    "E5M2_RNINF", "E5M2_DAZ_RNE", "E4M3_RNE", "E4M3_IEEE_RNE", "E3M4_RNE",
    "FP4_NEAREST", "BFLOAT16_RNE", "FLOAT16_RNE", "FLOAT16_DAZ_RNE",
    "E5M2_NOINF_RNE", "E5M2_FLEX_RNE")


def native_ref_inputs(mode: str):
    """tests/test_native_ref.py's inputs for ``mode`` (its rng seeded 0)."""
    import numpy as np
    span = {"E5M2": 57344.0, "E4M3": 448.0, "E4M3_IEEE": 240.0,
            "E3M4": 30.0, "FP4": 1.0, "E5M2_NOINF": 57344.0,
            "E5M2_FLEX": 57344.0}.get(mode.rsplit("_", 1)[0], 1e4)
    rng = np.random.default_rng(0)
    return np.concatenate([
        rng.normal(0, span / 8, 4096), rng.normal(0, span * 2, 512),
        rng.normal(0, 1e-3, 512),
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, span]),
    ]).astype(np.float32)


def differ_by_class(got, want) -> int:
    """Elements that differ: f32 bits, or NaN against not-NaN."""
    import numpy as np
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(want)
    return int((np.isnan(got) != nan).sum()
               + (got[~nan].view(np.uint32) != want[~nan].view(np.uint32))
               .sum())


def sum_order_bound(a, b):
    """K 2^-24 (|a| @ |b|): the worst case of an f32 sum of K products
    against the exact one, elementwise, for ``a @ b`` (f64 operands)."""
    return a.shape[-1] * 2.0 ** -24 * (a.abs() @ b.abs())


# The statistical limit of an f32 product, in units of 2^-24 times the
# root sum of squares of each output's K products (sqrt(K) rms|ab|).
# Zero-mean products summed in f32 err about sqrt(K / 6) such units (26
# at K = 4096, some 150 at the worst of 10^7 outputs); TF32 operands
# (10-bit mantissas) err some 2^13 times more.  Set between the two, it
# fails a product that TF32 computed, which the worst-case bound does not.
SUM_ORDER_STAT_C = 1024.0


def sum_order_stat(a, b):
    """2^-24 sqrt((a*a) @ (b*b)), elementwise, for ``a @ b`` (f64)."""
    return 2.0 ** -24 * ((a * a) @ (b * b)).sqrt()


def phase_sparse(record):
    """The sparsity engine on the card at full width, against its run on
    the CPU: sparsify_weight on the gate weight, sparsify_outgrad on a
    decoder's output gradient, fake_quant_sparse of the pruned weight as a
    COO tensor through K1, SparseLinear's forward and backward against
    f64, and K1 against the framework-free references."""
    import numpy as np
    import torch
    from fp8tpu_torch.kernels import cast_kernel
    from fp8tpu_torch.numerics import cast as tcast
    from fp8tpu_torch.numerics import golden, native_ref, prng
    from fp8tpu_torch.quant.config import TensorQuantConfig
    from fp8tpu_torch.quant.fakequant import fake_quant, fake_quant_sparse
    from fp8tpu_torch.sparse import (SparseConfig, SparseLinear, SparseState,
                                     sparsify_outgrad, sparsify_weight,
                                     sparsity_of, stochastic_prune,
                                     stochastic_prune_threshold,
                                     weight_mask_step)
    problems, out = [], {}
    gen = torch.Generator().manual_seed(18)

    def state(step, w_alpha=65504.0, g_alpha=65504.0, device="cpu"):
        f32 = dict(dtype=torch.float32, device=device)
        return SparseState(torch.tensor(w_alpha, **f32),
                           torch.tensor(g_alpha, **f32),
                           torch.tensor(step, dtype=torch.int32,
                                        device=device))

    # (a) weight pruning on a refresh step
    w = torch.randn(SPARSE_GATE, generator=gen) / SPARSE_GATE[0] ** 0.5
    cfg = SparseConfig(weight=True, weight_sparsity=0.5, alpha_window=50)
    key = prng.key(5)
    n_samp = int(w.numel() * cfg.sample_factor)
    draws = prng.randint(key, 0, w.numel(), (n_samp,), device="cuda")
    draws_diff = int((draws.cpu() != prng.randint(key, 0, w.numel(),
                                                  (n_samp,))).sum())
    wc = w.cuda()
    torch.cuda.synchronize()
    t = time.perf_counter()
    pruned, alpha = sparsify_weight(wc, cfg, state(50, device="cuda"), key)
    torch.cuda.synchronize()
    w_ms = 1000 * (time.perf_counter() - t)
    pruned_cpu, alpha_cpu = sparsify_weight(w, cfg, state(50), key)
    reached = float(sparsity_of(pruned))
    w_diff = bits_equal(pruned.cpu(), pruned_cpu)
    a_diff = bits_equal(alpha.cpu().reshape(1), alpha_cpu.reshape(1))
    out["weight"] = {"shape": SPARSE_GATE, "samples": n_samp,
                     "randint_differ": draws_diff,
                     "alpha": float(alpha), "alpha_differ": a_diff,
                     "pruned_differ": w_diff, "sparsity": reached,
                     "card_ms": w_ms}
    print(f"sparse: sparsify_weight {SPARSE_GATE} at 0.5 (refresh step): "
          f"{n_samp} randint draws, {draws_diff} differ from the CPU; "
          f"alpha {float(alpha):.6g} ({a_diff} bits differ), pruned "
          f"weight {w_diff} differ, sparsity {reached:.4f}; {w_ms:.1f} ms "
          "on the card")
    if draws_diff or a_diff or w_diff:
        problems.append("sparsify_weight differs from the CPU")
    if abs(reached - 0.5) > 0.01:
        problems.append(f"sparsity {reached} is not within 0.01 of 0.5")

    # (b) output-gradient pruning, unbiased
    g = torch.randn(SPARSE_GRAD, generator=gen) * 1e-3
    gcfg = SparseConfig(outgrad=True, outgrad_sparsity=0.5, alpha_window=50)
    gkey = prng.key(6)
    u_card = prng.uniform(gkey, SPARSE_GRAD, device="cuda")
    u_diff = bits_equal(u_card.cpu(), prng.uniform(gkey, SPARSE_GRAD))
    del u_card
    gc = g.cuda()
    torch.cuda.synchronize()
    t = time.perf_counter()
    y, ga = sparsify_outgrad(gc, gcfg, state(50, device="cuda"), gkey)
    torch.cuda.synchronize()
    g_ms = 1000 * (time.perf_counter() - t)
    # the CPU's refresh-step alpha (sparsify_outgrad's threshold), alone
    ga_cpu = stochastic_prune_threshold(g, gcfg.outgrad_sparsity)
    rel = abs(float(ga) - float(ga_cpu)) / float(ga_cpu)
    # the output from the CPU's alpha, on both sides
    y_card = stochastic_prune(gc, ga_cpu.cuda(), gkey)
    y_diff = bits_equal(y_card.cpu(), stochastic_prune(g, ga_cpu, gkey))
    d = (y.double() - gc.double()).flatten()
    se = float(d.std()) / d.numel() ** 0.5
    bias = abs(float(d.mean()))
    g_sp = float(sparsity_of(y))
    out["outgrad"] = {"shape": SPARSE_GRAD, "uniform_differ": u_diff,
                      "alpha": float(ga), "alpha_cpu": float(ga_cpu),
                      "alpha_rel": rel, "output_differ": y_diff,
                      "mean_bias": bias, "standard_error": se,
                      "sparsity": g_sp, "card_ms": g_ms}
    print(f"sparse: sparsify_outgrad {SPARSE_GRAD} at 0.5: uniform draws "
          f"{u_diff} differ from the CPU; alpha {float(ga):.6g} against "
          f"{float(ga_cpu):.6g} on the CPU ({rel:.2e} relative, limit "
          f"{SPARSE_THRESHOLD_RTOL:g}); output from the CPU's alpha "
          f"{y_diff} differ; mean shift {bias:.3e} = "
          f"{bias / se:.2f} standard errors; sparsity {g_sp:.4f}; "
          f"{g_ms:.1f} ms on the card")
    if u_diff or y_diff or rel > SPARSE_THRESHOLD_RTOL or bias > 4 * se:
        problems.append("sparsify_outgrad differs from the CPU or is biased")
    del y, y_card, gc, d

    # (c) the pruned weight as a COO tensor through K1
    coo = pruned.to_sparse_coo().coalesce()
    coo_cpu = pruned_cpu.to_sparse_coo().coalesce()
    out["coo"] = {"nnz": int(coo._nnz())}
    for label, c, k in (("none", TensorQuantConfig("e4m3", "rne"), None),
                        ("per-tensor", TensorQuantConfig(
                            "e4m3", "rne", scaling="per-tensor"), None),
                        ("sr", TensorQuantConfig("e4m3", "stochastic"),
                         prng.key(7))):
        k0 = cast_kernel.launches
        q = fake_quant_sparse(coo, c, k)
        torch.cuda.synchronize()
        launched = cast_kernel.launches - k0
        plain = fake_quant_sparse(coo_cpu, c, k)
        v_diff = bits_equal(q.values().cpu(), plain.values())
        idx_same = bool(torch.equal(q.indices().cpu(), coo_cpu.indices()))
        dense_diff = None
        if k is None:
            dense = fake_quant(pruned, c)
            i = q.indices()
            dense_diff = bits_equal(dense[i[0], i[1]], q.values())
        out["coo"][label] = {"k1_launches": launched,
                             "values_differ": v_diff,
                             "indices_equal": idx_same,
                             "dense_differ": dense_diff}
        print(f"sparse: fake_quant_sparse e4m3 {label} of {coo._nnz()} "
              f"values: {launched} K1 launch, {v_diff} differ from the "
              f"plain cast on the CPU, indices equal {idx_same}, against "
              f"the dense fake_quant {dense_diff}")
        if launched != 1 or v_diff or not idx_same or dense_diff:
            problems.append(f"fake_quant_sparse {label} is wrong")
    del coo, coo_cpu, pruned, pruned_cpu

    # (d) SparseLinear forward and backward against f64
    lin = SparseLinear(SPARSE_GATE[0], SPARSE_GATE[1]).cuda()
    with torch.no_grad():
        lin.weight.copy_(wc.t())
        lin.threshold.copy_(torch.linspace(0.0, 0.03, SPARSE_GATE[1]))
        lin.bias.copy_(torch.linspace(-0.1, 0.1, SPARSE_GATE[1]))
    x = torch.randn(SPARSE_LINEAR_TOKENS, SPARSE_GATE[0], device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3))
    ct = torch.randn(SPARSE_LINEAR_TOKENS, SPARSE_GATE[1], device="cuda",
                     generator=torch.Generator("cuda").manual_seed(4))
    x.requires_grad_(True)
    ref = SparseLinear(SPARSE_GATE[0], SPARSE_GATE[1]).cuda().double()
    ref.load_state_dict({k: v.double() for k, v in lin.state_dict().items()})
    xr = x.detach().double().requires_grad_(True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    yl = lin(x)
    (yl * ct).sum().backward()
    torch.cuda.synchronize()
    lin_ms = 1000 * (time.perf_counter() - t)
    yr = ref(xr)
    (yr * ct.double()).sum().backward()
    wm = ref.weight.detach() * (ref.weight.detach().abs()
                                - ref.threshold.detach()[:, None] > 0)
    operands = {"y": (xr.detach(), wm.t()), "dx": (ct.double(), wm),
                "dw": (ct.double().t(), xr.detach())}
    results = {"y": (yl, yr), "dx": (x.grad, xr.grad),
               "dw": (lin.weight.grad, ref.weight.grad)}
    lin_rows, stat_rows = {}, {}
    for name, (a, b) in operands.items():
        got, want = results[name]
        # dw is that product times the mask and its surrogate's term
        # (mask + 2|w| at most, and more roundings): 4x, as before
        k = 4.0 if name == "dw" else 1.0
        err = (got.detach().double() - want).abs()
        ratio = float((err / (k * sum_order_bound(a, b) + 1e-300)).max())
        stat = float((err / (k * sum_order_stat(a, b) + 1e-300)).max())
        lin_rows[name], stat_rows[name] = ratio, stat
        if not ratio <= 1.0:
            problems.append(f"SparseLinear {name} outside the f32 bound")
        if not stat <= SUM_ORDER_STAT_C:
            problems.append(f"SparseLinear {name} outside the statistical "
                            f"f32 limit ({stat:.1f} > {SUM_ORDER_STAT_C})")
    # the statistical limit's power: the forward product on TF32 operands
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yt = x.detach() @ wm.float().t() + lin.bias.detach()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    tf32_stat = float(((yt.double() - yr.detach()).abs()
                       / (sum_order_stat(*operands["y"]) + 1e-300)).max())
    if not tf32_stat > SUM_ORDER_STAT_C:
        problems.append(f"the statistical limit passes a TF32 product "
                        f"({tf32_stat:.1f})")
    del yt
    tg = (lin.threshold.grad.double() - ref.threshold.grad).abs().max()
    t_scale = float(ref.threshold.grad.abs().max())
    lin_rows["threshold_rel"] = float(tg) / max(t_scale, 1e-30)
    probe = torch.tensor([-2.0, -1.0, -0.7, -0.4, -0.2, 0.0, 0.2, 0.3999,
                          0.4, 0.4001, 0.7, 1.0, 1.0001, 2.0])
    pc = probe.cuda().requires_grad_(True)
    weight_mask_step(pc).sum().backward()
    window = torch.where(probe.abs() > 1.0, 0.0, torch.where(
        probe.abs() > 0.4, 0.4, 2.0 - 4.0 * probe.abs()))
    win_diff = bits_equal(pc.grad.cpu(), window)
    out["sparse_linear"] = {"tokens": SPARSE_LINEAR_TOKENS,
                            "bound_ratio": lin_rows,
                            "stat_ratio": stat_rows, "tf32_stat": tf32_stat,
                            "window_differ": win_diff, "card_ms": lin_ms}
    print(f"sparse: SparseLinear {SPARSE_GATE[0]} -> {SPARSE_GATE[1]} on "
          f"{SPARSE_LINEAR_TOKENS} tokens, forward and backward "
          f"{lin_ms:.1f} ms: against f64, worst share of the f32 bound "
          + ", ".join(f"{k} {v:.3f}" for k, v in lin_rows.items())
          + "; worst in units of the statistical limit's 2^-24 sqrt(K) "
          "rms|ab| " + ", ".join(f"{k} {v:.1f}" for k, v in stat_rows.items())
          + f" (limit {SUM_ORDER_STAT_C:.0f}; a TF32 forward {tf32_stat:.1f})"
          + f"; the mask gradient's window at 14 points: {win_diff} differ")
    if win_diff or lin_rows["threshold_rel"] > 1e-3:
        problems.append("SparseLinear's mask gradient does not follow the "
                        "window")
    del lin, ref, x, xr, ct, yl, yr, wc

    # (e) K1 against golden and the native twin
    native = native_ref.available()
    refs = {}
    for mode in NATIVE_MODES:
        xs = native_ref_inputs(mode)
        k0 = cast_kernel.launches
        got = tcast.qdq_mode_string(torch.from_numpy(xs).cuda(), mode).cpu()
        launched = cast_kernel.launches - k0
        want = golden.cast_mode_string(xs, mode)
        row = {"k1_launches": launched,
               "vs_golden": differ_by_class(got.numpy(), want),
               "native_vs_golden": differ_by_class(
                   native_ref.cast(xs, mode), want) if native else None}
        refs[mode] = row
        if launched != 1 or row["vs_golden"] or row["native_vs_golden"]:
            problems.append(f"K1 / golden / native differ on {mode}")
    out["k1_references"] = refs
    print(f"sparse: K1 on the card against golden over the "
          f"{len(NATIVE_MODES)} deterministic mode strings: "
          f"{sum(r['vs_golden'] for r in refs.values())} elements differ; "
          f"the native twin {'built' if native else 'NOT BUILT'}, "
          f"{sum(r['native_vs_golden'] or 0 for r in refs.values())} differ")
    if not native:
        problems.append("the native twin did not build")
    record["sparse"] = out
    if problems:
        raise PhaseError("; ".join(problems))


# -- phases vision and bert -----------------------------------------------------

VIT_BATCH = 32                 # ViT-B/16 images a batch
VISION_BATCH = 8               # the conv families' images a batch
IMAGE = 224                    # the images' height and width
# (constructor, exempt list, folds BatchNorm): the nine conv families of
# fp8tpu_torch.models.vision at their full-width constructors
VISION_FAMILIES = (
    ("vgg11", "VGG_EXEMPT", True), ("mobilenet", "MOBILENET_EXEMPT", True),
    ("inception", "INCEPTION_EXEMPT", True),
    ("densenet", "DENSENET_EXEMPT", True),
    ("shufflenet", "SHUFFLENET_EXEMPT", True),
    ("squeezenet", "SQUEEZENET_EXEMPT", False),
    ("mobilenet_v2", "MBCONV_EXEMPT", True),
    ("mobilenet_v3", "MBCONV_EXEMPT", True),
    ("efficientnet_b0", "MBCONV_EXEMPT", True))
BERT_BATCH, BERT_SEQ = 8, 384  # SQuAD's max_seq_length
PTQ_CORR = 0.95                # the JAX package's PTQ gate


def grouped_convs(model):
    """Paths of the grouped (depthwise included) convs, which hw patching
    leaves off the engine."""
    from fp8tpu_torch import linen
    return {n.replace(".", "/") for n, m in model.named_modules()
            if isinstance(m, linen.Conv) and m.feature_group_count != 1}


def launch_counts():
    from fp8tpu_torch.kernels import cast_kernel, qmatmul
    return {"K1": cast_kernel.launches, "K2": qmatmul.launches,
            "K2_prepass": qmatmul.k2_launches["prepass"]}


def launch_delta(before):
    return {k: v - before[k] for k, v in launch_counts().items()}


class _CheckedK2:
    """While open, the first ``limit`` K2 launches (GEMMs and engine
    convs) are each held against the exact product of their own cast
    operands (k2_reference): ``ratios`` takes |err| / tolerance."""

    def __init__(self, limit=None):
        self.limit, self.ratios = limit, []

    def _take(self):
        return self.limit is None or len(self.ratios) < self.limit

    def __enter__(self):
        from fp8tpu_torch.kernels import qmatmul
        self.launch, self.conv = qmatmul._launch, qmatmul.conv

        def launch(*args, impl="bitexact", **kw):
            out = self.launch(*args, impl=impl, **kw)
            if self._take():
                self.ratios.append(k2_launch_error(out, args, impl))
            return out

        def conv(*args):
            out = self.conv(*args)
            if self._take():
                self.ratios.append(k2_ratio(conv_rows(out), *k2_reference(
                    *k2_conv_operands(*args))))
            return out

        qmatmul._launch, qmatmul.conv = launch, conv
        return self

    def __exit__(self, *exc):
        from fp8tpu_torch.kernels import qmatmul
        qmatmul._launch, qmatmul.conv = self.launch, self.conv


def corr(a, b) -> float:
    import torch
    return float(torch.corrcoef(torch.stack(
        [a.flatten().double(), b.flatten().double()]))[0, 1])


def timed_forwards(fn, n=3):
    """ms of each of ``n`` calls of ``fn``, the card drained around each."""
    import torch
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1000.0 * (time.perf_counter() - t))
    return times


def time_k2_gemm(label, xq, w, fmt_w, launches):
    """K2 at one GEMM shape of a path, ``qdq(x) @ w`` with x cast e4m3 at
    its per-tensor scale (and w at its own when ``fmt_w``): device time
    by CUDA-graph replay, the plain version, the bound (bytes over HBM or
    3 bf16 MMAs a product at the dense rate, the larger), f32
    torch.matmul on the cast operands (TF32 off), and the launch against
    k2_reference: a row of the kernels record."""
    import torch
    from fp8tpu_torch._device import full_fp32
    from fp8tpu_torch.kernels import qmatmul
    from fp8tpu_torch.numerics.formats import RoundMode
    from fp8tpu_torch.numerics.scaling import per_tensor
    from fp8tpu_torch.tools import device_ms
    rne = RoundMode.RNE
    m, k = xq.shape
    n = w.shape[1]
    sx = per_tensor(xq, "e4m3")
    sw = per_tensor(w, "e4m3") if fmt_w else 1.0
    args = (xq, w, "e4m3", rne, fmt_w, rne, sx, sw)
    got = qmatmul.qdq_matmul(*args)
    want = qmatmul.plain(*args)
    a, b = k2_operands(*args, 0, "bitexact")
    ratio = k2_ratio(got, *k2_reference(a, b))

    def library():
        with full_fp32():
            return torch.matmul(a, b)

    t_k = device_ms(lambda: qmatmul.qdq_matmul(*args))
    t_p = cuda_ms(lambda: qmatmul.plain(*args), iters=3, warmup=1)
    t_l = device_ms(library)
    flops = 2.0 * m * n * k
    t_bytes = 4.0 * (m * k + k * n + m * n) / HBM_BYTES_PER_S * 1e3
    t_mma = 3 * flops / BF16_TC_FLOPS * 1e3
    err = float((got - want).abs().max())
    print(f"time k2 {label} M={m} K={k} N={n} (x e4m3, w {fmt_w}): kernel "
          f"{t_k:.4f} ms ({flops / t_k / 1e9:.2f} TFLOP/s), plain {t_p:.4f} "
          f"ms, bound {max(t_bytes, t_mma):.4f} ms (bytes {t_bytes:.4f}, 3 "
          f"bf16 MMAs {t_mma:.4f}), f32 torch.matmul on the cast operands "
          f"{t_l:.4f} ms; |kernel - plain| {err:.3e}, |err| / tolerance "
          f"{ratio:.3e}")
    if ratio > 1.0:
        raise PhaseError(f"K2 at {label} is {ratio} of k2_reference's bound")
    return {"name": f"qdq_matmul at {label} ({m}x{k}x{n})", "route": "cuda",
            "source": "fp8tpu_torch/kernels/csrc/qmatmul.cu",
            "replaces": "fp8tpu/kernels/qmatmul.py:193",
            "launches": launches, "max_abs_err": err, "ms": t_k,
            "plain_ms": t_p, "bound_ms": max(t_bytes, t_mma),
            "bound_by": "operations" if t_mma >= t_bytes else "bytes",
            "library_ms": t_l, "err_over_tol": ratio}


def phase_vision(record):
    """ViT-B/16 e4m3 PTQ with hw patching at batch 32 x 224^2, and the nine
    conv families at their full-width constructors, batch 8 x 224^2:
    launches a forward against what the model's table predicts, K2 never
    on a grouped conv, every K2 launch of one forward against the exact
    product of its operands, correlation with the fp32 forward."""
    import torch
    import fp8tpu_torch as ft
    from fp8tpu_torch.kernels import qmatmul
    from fp8tpu_torch.models import vision
    from fp8tpu_torch.numerics import cast as cast_mod
    from fp8tpu_torch.quant import hw_patch
    from fp8tpu_torch.quant.policy import LayerKind

    policy = ft.get_policy("e4m3", training=False).with_hw_patching()
    problems, rows, profiles = [], [], {}
    cgen = torch.Generator(device="cuda").manual_seed(7)

    def run(name, model, batch, exempt, has_bn, ctor=None):
        x = torch.randn(batch, 3, IMAGE, IMAGE, device="cuda", generator=cgen)
        calib = torch.randn(batch, 3, IMAGE, IMAGE, device="cuda",
                            generator=cgen)
        with torch.no_grad():
            if has_bn:                  # BN statistics from train passes
                model.train()
                model(calib)
                model(x)
            model.eval()
            ref = model(x)
        infer = ctor(device="cuda", norm_mode="scale_shift") if has_bn \
            else None
        pol = policy.with_exempt(*exempt)
        t0 = time.perf_counter()
        qm = ft.quantize_model(model, (x,), policy=policy, fuse_bn=has_bn,
                               inference_model=infer,
                               calibration_batches=[calib],
                               list_exempt_layers=exempt, device="cuda")
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        dense, grouped = hw_patch.engine_convs(qm.model, pol), \
            grouped_convs(qm.model)
        dense_modules = sum(
            1 for p, k in qm.module_table.items()
            if k == LayerKind.DENSE and pol.resolve(p, k) is not None)
        routed = set()
        paths = {id(m): n.replace(".", "/")
                 for n, m in qm.model.named_modules()}
        patchable = hw_patch.conv_patchable

        def spy(module):
            ok = patchable(module)
            if ok:
                routed.add(paths[id(module)])
            return ok

        with torch.no_grad(), _Counting(qmatmul, "plain", forbid=True), \
                _Counting(qmatmul, "conv_plain", forbid=True), \
                _Counting(cast_mod, "qdq_plain", forbid=True):
            hw_patch.conv_patchable = spy
            try:
                before = launch_counts()
                out = qm(x)
                torch.cuda.synchronize()
                per_fwd = launch_delta(before)
            finally:
                hw_patch.conv_patchable = patchable
            with _CheckedK2() as checked:
                qm(x)
            ms = timed_forwards(lambda: qm(x))
        c = corr(out, ref)
        finite = bool(torch.isfinite(out).all())
        worst = max(checked.ratios, default=0.0)
        if name in ("vit_b16", "densenet"):
            with torch.no_grad():
                profiles[name] = profile_forward(qm, x, min(ms))
        row = {"model": name, "batch": batch, "quantize_model_s": quantize_s,
               "ms_per_batch": ms, "images_per_s": batch / (min(ms) / 1e3),
               "launches_per_forward": per_fwd, "engine_convs": len(dense),
               "grouped_convs": len(grouped), "dense_modules": dense_modules,
               "k2_checked": len(checked.ratios), "k2_worst": worst,
               "corr_vs_fp32": c, "finite": finite}
        print(f"vision: {name} batch {batch}: quantize_model "
              f"{quantize_s:.2f} s, {min(ms):.2f} ms/batch "
              f"({', '.join(f'{t:.2f}' for t in ms)}), "
              f"{row['images_per_s']:.1f} images/s; launches a forward "
              f"{per_fwd} ({len(dense)} engine convs, {len(grouped)} grouped "
              f"convs off the engine, {dense_modules} quantized Dense); "
              f"{len(checked.ratios)} K2 launches within "
              f"{worst:.3e} of k2_reference's bound; corr vs fp32 {c:.5f}")
        bad = []
        if not finite or c <= PTQ_CORR:
            bad.append(f"correlation {c} (finite {finite})")
        if per_fwd["K2"] != len(dense) or \
                per_fwd["K2_prepass"] != 2 * len(dense):
            bad.append(f"{per_fwd} K2 launches for {len(dense)} engine convs")
        if routed != dense or routed & grouped:
            bad.append(f"engine convs {sorted(routed ^ dense)[:4]} differ "
                       "from the table's")
        if len(checked.ratios) != len(dense) or worst > 1.0:
            bad.append(f"{len(checked.ratios)} K2 launches checked, worst "
                       f"{worst} of the bound")
        problems.extend(f"{name}: {b}" for b in bad)
        rows.append(row)
        return qm, x

    # ViT-B/16: hw patching reaches no module of it (its Dense layers and
    # its attention einsums are outside the engine in the JAX package, as
    # in the reference), so its forward is K1 on every quantized Dense
    # input and K2 nowhere; K2 is timed at its fc1 shape below.
    vit = vision.vit_b16(device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(0))
    captured = {}
    hook = vit.blk0_fc1.register_forward_pre_hook(
        lambda mod, a: captured.setdefault("x", a[0].detach()))
    qm, x = run("vit_b16", vit, VIT_BATCH, vision.VIT_EXEMPT, False)
    hook.remove()
    vit_row = rows[-1]
    if vit_row["launches_per_forward"]["K1"] != vit_row["dense_modules"]:
        problems.append(f"vit_b16: {vit_row['launches_per_forward']} K1 "
                        f"launches for {vit_row['dense_modules']} Dense")
    xf = captured["x"]
    fc1 = time_k2_gemm("ViT-B/16 fc1", xf.reshape(-1, xf.shape[-1]),
                       qm.variables["blk0_fc1.weight"].t().contiguous(),
                       None, 0)
    del qm, x, vit, captured
    torch.cuda.empty_cache()
    for i, (name, exempt, has_bn) in enumerate(VISION_FAMILIES):
        ctor = getattr(vision, name)
        model = ctor(device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(10 + i))
        run(name, model, VISION_BATCH, getattr(vision, exempt), has_bn, ctor)
        del model
        torch.cuda.empty_cache()
    record["vision"] = {"models": rows, "k2_vit_fc1": fc1,
                        "profiles": profiles}
    if problems:
        raise PhaseError("; ".join(problems))
    return [fc1]


def phase_bert(record):
    """BERT-base QA (bert_base_config, random weights from a seed) at 8 x
    384 tokens, hybrid PTQ with the reference's recipe, as
    bert_squad_ptq.py runs it (K1 casts) and with hw patching (K2 on
    every (batch, head) slice of both BatchMatmuls): launches, ms, one
    layer's K2 launches against k2_reference, start logits against fp32;
    then K2 at a slice's shape."""
    import torch
    import fp8tpu_torch as ft
    from fp8tpu_torch.kernels import qmatmul
    from fp8tpu_torch.models import bert
    from fp8tpu_torch.numerics import cast as cast_mod
    from fp8tpu_torch.quant import hw_patch

    cfg = bert.bert_base_config()
    model = bert.bert_for_qa(cfg, "cuda", torch.Generator(
        device="cuda").manual_seed(0))
    cgen = torch.Generator(device="cuda").manual_seed(3)
    ids = torch.randint(0, cfg.vocab_size, (BERT_BATCH, BERT_SEQ),
                        device="cuda", generator=cgen)
    mask = torch.ones_like(ids)
    mask[1, BERT_SEQ * 3 // 4:] = 0      # a padded sequence
    with torch.no_grad():
        ref = model(ids, mask)
    slices = cfg.n_layers * BERT_BATCH * cfg.n_heads * 2
    problems, runs = [], {}
    captured = {}
    for hw in (False, True):
        policy = ft.get_policy("hybrid", training=False)
        if hw:
            policy = policy.with_hw_patching()
        t0 = time.perf_counter()
        qm = ft.quantize_model(model, (ids[:1], mask[:1]), policy=policy,
                               calibration_batches=[(ids, mask)],
                               list_exempt_layers=bert.BERT_QA_EXEMPT,
                               list_layers_output_fused=bert.BERT_OUTPUT_FUSED,
                               device="cuda")
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        with torch.no_grad(), _Counting(qmatmul, "plain", forbid=True), \
                _Counting(cast_mod, "qdq_plain", forbid=True):
            before = launch_counts()
            out = qm(ids, mask)
            torch.cuda.synchronize()
            per_fwd = launch_delta(before)
            engine = hw_patch.patched_matmul

            def first(a, b, *rest):
                captured.setdefault("slice", (a, b))
                return engine(a, b, *rest)

            with _CheckedK2(limit=2 * BERT_BATCH * cfg.n_heads) as checked:
                hw_patch.patched_matmul = first
                try:
                    qm(ids, mask)
                finally:
                    hw_patch.patched_matmul = engine
            ms = timed_forwards(lambda: qm(ids, mask))
        c = corr(out[0], ref[0])
        finite = all(bool(torch.isfinite(t).all()) for t in out)
        worst = max(checked.ratios, default=0.0)
        tag = "hw" if hw else "casts"
        with torch.no_grad():
            profile = profile_forward(lambda _: qm(ids, mask), None, min(ms))
        runs[tag] = {"quantize_model_s": quantize_s, "ms_per_batch": ms,
                     "profile": profile,
                     "sequences_per_s": BERT_BATCH / (min(ms) / 1e3),
                     "launches_per_forward": per_fwd,
                     "k2_checked": len(checked.ratios), "k2_worst": worst,
                     "corr_start_vs_fp32": c, "finite": finite}
        print(f"bert: BERT-base QA {BERT_BATCH} x {BERT_SEQ}, hybrid"
              f"{' + hw patching' if hw else ''}: quantize_model "
              f"{quantize_s:.2f} s, {min(ms):.2f} ms/batch "
              f"({', '.join(f'{t:.2f}' for t in ms)}), "
              f"{runs[tag]['sequences_per_s']:.1f} sequences/s; launches a "
              f"forward {per_fwd}; layer 0's {len(checked.ratios)} K2 "
              f"launches within {worst:.3e} of k2_reference's bound; start "
              f"logits corr vs fp32 {c:.5f}")
        want = slices if hw else 0
        if per_fwd["K2"] != want or per_fwd["K2_prepass"] != 2 * want:
            problems.append(f"{tag}: {per_fwd}, expected {want} K2 GEMMs")
        if hw and (len(checked.ratios) != 2 * BERT_BATCH * cfg.n_heads
                   or worst > 1.0):
            problems.append(f"{len(checked.ratios)} K2 launches checked, "
                            f"worst {worst} of the bound")
        if not finite or c <= PTQ_CORR:
            problems.append(f"{tag}: correlation {c} (finite {finite})")
        del qm, out
    # the engine takes both operands of the 24 BatchMatmuls off K1
    k1_moved = runs["casts"]["launches_per_forward"]["K1"] \
        - runs["hw"]["launches_per_forward"]["K1"]
    if k1_moved != 2 * 2 * cfg.n_layers:
        problems.append(f"hw patching moved {k1_moved} K1 casts, expected "
                        f"{4 * cfg.n_layers}")
    a, b = captured["slice"]
    row = time_k2_gemm("a BERT-base score slice", a.contiguous().float(),
                       b.contiguous().float(), "e4m3", slices)
    # the control: the same recipe on a model drawn at the layers' own
    # std 1/sqrt(fan_in) rather than BERT's 0.02, not gated: it
    # decorrelates by depth, whatever the kernels
    del model
    torch.manual_seed(0)
    control = bert.bert_for_qa(cfg, "cuda")
    qm = ft.quantize_model(control, (ids[:1], mask[:1]), dtype="hybrid",
                           list_exempt_layers=bert.BERT_QA_EXEMPT,
                           list_layers_output_fused=bert.BERT_OUTPUT_FUSED,
                           device="cuda")
    with torch.no_grad():
        c_ctl = corr(qm(ids, mask)[0], control(ids, mask)[0])
    print(f"bert: control, the model drawn at 1/sqrt(fan_in): start logits "
          f"corr vs fp32 {c_ctl:.5f} (not gated)")
    record["bert"] = {"runs": runs, "k2_slice": row, "k1_moved": k1_moved,
                      "control_corr_fan_in_init": c_ctl}
    if problems:
        raise PhaseError("; ".join(problems))
    return [row]


# -- phase examples ------------------------------------------------------------

EXAMPLE_KERNELS = {
    "K1": ("cast_vec", "cast_scalar", "cast_blocked"),
    "K3/K5": ("ws::stream_kernel", "w_gemm"),
    "K4": ("paged_attention_kernel",),
    "K6": ("ring_store_kernel",),
    "P3": ("adam8_",),
}
# (script, argv, kernels that must launch)
EXAMPLE_RUNS = (
    ("train_fp8", ["--d-model", "768", "--n-layers", "12", "--batch-size",
                   "8", "--seq-len", "256", "--opt8", "--emb-fmt", "e4m3",
                   "--steps", "3"], ("K1", "P3")),
    ("serve_llm", ["--d-model", "4096", "--n-layers", "16", "--weight-fmt",
                   "e4m3", "--kv-fmt", "int8", "--slots", "8", "--requests",
                   "8", "--max-new-tokens", "32"], ("K3/K5", "K6")),
    ("serve_llm", ["--d-model", "4096", "--n-layers", "16", "--weight-fmt",
                   "e4m3", "--kv-fmt", "int8", "--slots", "8", "--requests",
                   "8", "--max-new-tokens", "32", "--paged",
                   "--prefix-cache"], ("K3/K5", "K4")),
    ("serve_http", [], ("K3/K5", "K6")),
    ("serve_http", ["--paged"], ("K3/K5", "K4")),
    ("eval_ppl", ["--train", "20"], ("K1",)),
    ("resnet_ptq", ["--model", "resnet50", "--batch-size", "32",
                    "--num-samples", "64"], ("K1",)),
    ("resnet_qat", ["--epochs", "1", "--steps-per-epoch", "4"], ("K1",)),
    ("resnet_ptq", ["--model", "tiny_vit"], ("K1",)),
    ("launch_sweep", ["--models", "tiny_vit", "tiny_mobilenet", "resnet18",
                      "--dtypes", "e4m3"], ("K1",)),
    ("bert_squad_ptq", [], ("K1",)),
    # the training casts are torch ops (no K1), as in resnet_qat's steps
    ("bert_qa_finetune", ["--steps", "5"], ()),
)


def profiled_kernels(prof):
    """{kernel: device records} of a closed profile, by EXAMPLE_KERNELS's
    name keys.  Reads the profiler's raw records: building its Python
    event tree for a train run's ~10^5 launches took most of the phase
    (28.6 s of train_fp8's 33.7 s on an H100)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    raw = getattr(prof.profiler, "kineto_results", None)
    events = ((e.name(), e.device_type()) for e in raw.events()) \
        if raw is not None else ((e.name, e.device_type)
                                 for e in prof.events())
    recorded = dict.fromkeys(EXAMPLE_KERNELS, 0)
    for name, device in events:
        if device != cuda:
            continue
        for k, keys in EXAMPLE_KERNELS.items():
            if any(key in name for key in keys):
                recorded[k] += 1
    return recorded


def example_counts():
    """{kernel: launches so far} as the wrappers count them."""
    from fp8tpu_torch.kernels import (adam8, cast_kernel, inplace,
                                      int4_matmul, qmatmul)
    from fp8tpu_torch.kernels import paged_attention as k4
    return {"K1": cast_kernel.launches,
            "K3/K5": qmatmul.dequant_launches + int4_matmul.launches,
            "K4": k4.launches, "K6": inplace.launches, "P3": adam8.launches}


def http_requests(port: int):
    """Two requests over 127.0.0.1: (tokens, ...)."""
    import urllib.request
    got = []
    for i in range(2):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps({"prompt": [1 + i, 2, 3],
                             "max_new_tokens": 16}).encode(),
            headers={"Content-Type": "application/json"})
        got.append(json.loads(urllib.request.urlopen(req, timeout=600)
                              .read())["tokens"])
    return got


def example_rate(name, res, seconds):
    """(rate, unit) of a script's run."""
    if name == "train_fp8":
        return max(res["tokens_per_s"][1:] or res["tokens_per_s"]), "tokens/s"
    if name == "serve_llm":
        return res["tokens_per_s"], "tokens/s"
    if name == "serve_http":
        return sum(len(t) for t in res["until"]) / seconds, "tokens/s (wall)"
    if name == "eval_ppl":
        return res["tokens_per_s"]["train"], "tokens/s (training)"
    if name == "resnet_ptq":
        return res["images"] / res["seconds"]["e4m3"], "images/s"
    if name == "resnet_qat":
        return max(res["images_per_s"][1:]), "images/s"
    if name == "bert_squad_ptq":
        return res["sequences"] / seconds, "sequences/s (wall, both passes)"
    if name == "bert_qa_finetune":
        return max(res["sequences_per_s"][1:]), "sequences/s (training)"
    return None, ""


def phase_examples(record):
    """Each script of ``fp8tpu_torch.examples`` in-process through
    ``main(argv)`` on the card, inside a torch.profiler window: the
    kernels it must launch (wrapper counts and profiled device records),
    its wall seconds and rate, and its output's checks."""
    import importlib
    import math
    import socket
    import torch
    from torch.profiler import ProfilerActivity, profile
    problems, rows = [], []
    for name, argv, want in EXAMPLE_RUNS:
        mod = importlib.import_module(f"fp8tpu_torch.examples.{name}")
        kw = {}
        if name == "serve_http":
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
            s.close()
            argv = argv + ["--port", str(port)]
            kw["until"] = http_requests
        before = example_counts()
        t_open = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profile_lead_in()
            t0 = time.perf_counter()
            res = mod.main(argv, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        counts = {k: v - before[k] for k, v in example_counts().items()}
        recorded = profiled_kernels(prof)
        profile_s = time.perf_counter() - t_open - seconds
        rate, unit = example_rate(name, res, seconds)
        row = {"script": name, "argv": argv, "seconds": seconds,
               "profile_s": profile_s,
               "launches": counts, "profiled": recorded, "rate": rate,
               "unit": unit, "lines": res["lines"]}
        missing = [k for k in want if not counts[k] or not recorded[k]]
        checks = []
        if name == "train_fp8":
            steps = len(res["losses"])
            checks = [all(math.isfinite(v) for v in res["losses"]),
                      counts["P3"] == steps, counts["K1"] == steps]
            row["losses"] = res["losses"]
        elif name == "serve_llm":
            checks = [len(res["tokens"]) == 8,
                      all(len(v) == 32 for v in res["tokens"].values())]
        elif name == "serve_http":
            checks = [[len(t) for t in res["until"]] == [16, 16]]
        elif name == "eval_ppl":
            checks = [all(math.isfinite(v) for v in res["ppl"].values())]
            row["ppl"] = res["ppl"]
            row["tokens_per_s"] = res["tokens_per_s"]
        elif name == "resnet_ptq":
            checks = [all(bool(torch.isfinite(t).all())
                          for t in res["logits"].values())]
            row["top1"] = res["top1"]
        elif name in ("resnet_qat", "bert_qa_finetune"):
            checks = [all(math.isfinite(v) for v in res["losses"]),
                      len(res["losses"]) == (5 if name == "bert_qa_finetune"
                                             else 4)]
            row["losses"] = res["losses"]
        elif name == "launch_sweep":
            checks = [[(r["model"], r["dtype"]) for r in res["rows"]]
                      == [(m, "e4m3") for m in argv[1:4]],
                      all(bool(torch.isfinite(r["first_logits"]).all())
                          for r in res["rows"])]
            row["rows"] = [{k: v for k, v in r.items()
                            if k != "first_logits"} for r in res["rows"]]
        elif name == "bert_squad_ptq":
            checks = [all(bool(torch.isfinite(t).all())
                          for pair in res["logits"].values() for t in pair)]
            row["em"], row["drift"] = res["em"], res["drift"]
        rows.append(row)
        rate_s = f", {rate:.1f} {unit}" if rate else ""
        print(f"examples: {name} {' '.join(argv)}: {seconds:.1f} s{rate_s} "
              f"(the profiler {profile_s:.1f} s more); "
              f"launches {counts}; profiled {recorded}"
              + (f"; MISSING {missing}" if missing else "")
              + ("" if all(checks) else f"; checks {checks}"))
        if missing or not all(checks):
            problems.append(f"{name}: kernels {missing} did not launch"
                            if missing else f"{name}: output checks failed")
        del res, prof
        torch.cuda.empty_cache()
    record["examples"] = rows
    if problems:
        raise PhaseError("; ".join(problems))


# -- phase parallel: fp8tpu_torch.parallel over NCCL, a world of one ---------

# bench.py's flagship MLP: the serving decoder's d_model and d_ff, 64 rows.
TP_MLP = dict(rows=64, d_model=4096, d_ff=11008, chunks=4)
PP_WIDTH, PP_ROWS, PP_MICRO = 4096, 64, 4     # the pipeline's stage and batch
# moe_ffn at the MoE cell's expert layer (moe_config: d_model 2048, 8
# experts of d_ff 5504, top-2) on 512 tokens: capacity 160 a expert
MOE_PAR = dict(tokens=512, d_model=2048, d_ff=5504, experts=8)


def k3_bound(m, k, n, out_bytes):
    """(ms, "bytes" | "operations") a K3 launch needs at least: x (bf16),
    the payload (a byte an element), the scales and the output moved once,
    or its multiply-adds at the dense bf16 tensor-core rate."""
    t_bytes = (2.0 * m * k + k * n + 4.0 * n + out_bytes * m * n) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * m * n * k / BF16_TC_FLOPS * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops > t_bytes
                                 else "bytes")


def tp_k3_row(label, x, w8, s, out_dtype, launches, err, phase="parallel"):
    """K3 at one TP shape: kernel (CUDA-graph replay), plain version, bound,
    and torch.matmul on the payload converted to bf16 times the scale."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    from fp8tpu_torch.tools import device_ms
    m, k = x.shape
    n = w8.shape[1]
    t_k = device_ms(lambda: qmatmul.dequant_matmul(x, w8, s, out_dtype))
    t_p = cuda_ms(lambda: qmatmul.dequant_matmul_plain(x, w8, s, out_dtype),
                  iters=3, warmup=1)
    t_l = device_ms(lambda: (torch.matmul(x, w8.to(torch.bfloat16))
                             * s).to(out_dtype))
    b, by = k3_bound(m, k, n, torch.empty((), dtype=out_dtype).element_size())
    print(f"{phase}: K3 {label} {m}x{k}x{n} -> {out_dtype}: kernel "
          f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {b:.4f} ms ({by}), "
          f"(x @ w8.to(bf16)) * s {t_l:.4f} ms; launches on the path "
          f"{launches}, max |kernel - plain| {err:.3e}")
    return {"name": f"dequant_matmul ({label}, {m}x{k}x{n})",
            "route": "cuda",
            "source": "fp8tpu_torch/kernels/csrc/dequant_matmul.cu",
            "replaces": "fp8tpu/kernels/qmatmul.py:87",
            "launches": launches, "max_abs_err": err, "ms": t_k,
            "plain_ms": t_p, "bound_ms": b, "bound_by": by,
            "library_ms": t_l}


def tp_layout(prof):
    """The device records of one tp_mlp_block call in start order: (kind,
    stream, start us, end us) for K3 and NCCL kernels, and the other
    kernels counted."""
    import torch
    rows, other = [], 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                LEAD_KERNEL in e.name:
            continue
        start = e.time_range.start
        end = e.time_range.end
        stream = getattr(e, "device_resource_id", None)
        if kernel_kind(e.name).startswith("K3/K5"):
            rows.append(("K3", stream, start, end))
        elif "nccl" in e.name.lower():
            rows.append(("NCCL", stream, start, end))
        else:
            other += 1
    return sorted(rows, key=lambda r: r[2]), other


def parallel_tp(out, problems):
    """tp_mlp_block at TP_MLP through K3 on a one-rank model axis."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    from fp8tpu_torch.kernels import qmatmul
    from fp8tpu_torch.parallel import (chunk_columns, make_mesh, tp_matmul,
                                       tp_mlp_block)
    m, k, ff, chunks = (TP_MLP[n] for n in ("rows", "d_model", "d_ff",
                                            "chunks"))
    gen = torch.Generator("cuda").manual_seed(20)
    x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    up8, up_s = qmatmul.quantize_weights(
        torch.randn(k, ff, device="cuda", generator=gen) * k ** -0.5, "e4m3")
    down8, down_s = qmatmul.quantize_weights(
        torch.randn(ff, k, device="cuda", generator=gen) * ff ** -0.5, "e4m3")
    up_s, down_s = up_s.reshape(-1), down_s.reshape(-1)
    # the down weight laid out by chunk once, as a served weight would be:
    # each chunk's K3 launch reads its (ff, k / chunks) block in place
    down_c = chunk_columns(down8, chunks)
    mesh = make_mesh(model=1)

    def run():
        return tp_mlp_block(x, up8, up_s, down_c, down_s, mesh,
                            overlap_chunks=chunks)

    # The main path: counts from 0, every K3 launch's operands kept, no
    # plain version allowed, and the order in which the host issues the K3
    # launches and the collectives.
    seen, issued = [], []
    real, real_ar = tp_matmul.dequant_matmul, dist.all_reduce

    def keeping(xa, w, s, out_dtype=torch.bfloat16, row_scale=None):
        y = real(xa, w, s, out_dtype=out_dtype, row_scale=row_scale)
        seen.append((xa, w, s, out_dtype, y))
        issued.append("K3")
        return y

    def all_reduce(*a, **kw):
        issued.append("all_reduce" + ("(async)" if kw.get("async_op")
                                      else ""))
        return real_ar(*a, **kw)

    qmatmul.reset_launches()
    tp_matmul.dequant_matmul, dist.all_reduce = keeping, all_reduce
    try:
        with _Counting(qmatmul, "dequant_matmul_plain", forbid=True):
            y = run()
        torch.cuda.synchronize()
    finally:
        tp_matmul.dequant_matmul, dist.all_reduce = real, real_ar
    launches = qmatmul.dequant_launches
    # no chunk of the down weight was copied: each down launch read a
    # contiguous view of the chunk stack
    base = down_c.untyped_storage().data_ptr()
    in_place = [w.is_contiguous() and w.untyped_storage().data_ptr() == base
                for _, w, _, _, _ in seen[1:]]
    worst = {"up": 0.0, "down": 0.0}
    errs = {"up": 0.0, "down": 0.0}
    for i, (xa, w, s, od, got) in enumerate(seen):
        want = qmatmul.dequant_matmul_plain(xa, w, s, od)
        tol = gemm_tolerance(xa, w.float().abs(), s.reshape(1, -1), want, od)
        d = (got.float() - want.float()).abs()
        part = "up" if i == 0 else "down"
        worst[part] = max(worst[part], float((d / tol).max()))
        errs[part] = max(errs[part], float(d.max()))
    # the block against the plain composition from the same x
    h = F.silu(qmatmul.dequant_matmul_plain(x, up8, up_s).float()).to(
        torch.bfloat16)
    csz = k // chunks
    plain = torch.cat([qmatmul.dequant_matmul_plain(
        h, down8[:, c * csz:(c + 1) * csz], down_s[c * csz:(c + 1) * csz],
        torch.float32) for c in range(chunks)], 1).to(torch.bfloat16)
    block = float((y.float() - plain.float()).abs().max()
                  / plain.float().abs().max())
    print(f"parallel: tp_mlp_block {m} x {k} -> {ff} -> {k} (e4m3, bf16 x, "
          f"{chunks} chunks): K3 launches {launches} (1 up + {chunks} "
          f"down required), no plain version called; each launch against "
          f"dequant_matmul_plain on its own operands: worst |err| / K3's "
          f"bound up {worst['up']:.3e}, down {worst['down']:.3e} (<= 1 "
          f"required); the block against the plain composition "
          f"{block:.3e} of max|y|; finite {bool(torch.isfinite(y).all())}; "
          f"down launches reading their chunk in place {sum(in_place)} of "
          f"{len(in_place)} (all required)")
    if not all(in_place):
        problems.append("tp_mlp_block: a down chunk was copied")
    if launches != 1 + chunks or len(seen) != 1 + chunks:
        problems.append(f"tp_mlp_block: {launches} K3 launches")
    if max(worst.values()) > 1.0:
        problems.append(f"tp_mlp_block: a K3 launch at {worst} of its "
                        "bound")
    if not bool(torch.isfinite(y).all()) or block > 2e-2:
        problems.append(f"tp_mlp_block against the plain block {block}")

    # The host issues each chunk's all_reduce (async) right after its K3
    # launch, before the next chunk's.
    want_order = ["K3"] + ["K3", "all_reduce(async)"] * chunks
    print(f"parallel: the host's issue order {issued} "
          f"({'as' if issued == want_order else 'NOT as'} required: up, "
          f"then each chunk's K3 launch followed by its all_reduce)")
    if issued != want_order:
        problems.append(f"tp_mlp_block issued {issued}")
    # The device's layout of one call: K3 on the compute stream, NCCL's
    # kernels (if any) on its own stream after their chunk's K3 launch.
    prof = open_profile(run)
    layout, other = tp_layout(prof)
    k3 = [r for r in layout if r[0] == "K3"]
    nccl = [r for r in layout if r[0] == "NCCL"]
    host = [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU
            and ("allreduce" in e.name.lower().replace("_", "")
                 and "nccl" in e.name.lower())]
    t0 = layout[0][2] if layout else 0.0
    print(f"parallel: tp_mlp_block's trace: "
          + ", ".join(f"{kd}@{st}[{s - t0:.1f}-{e - t0:.1f} us]"
                      for kd, st, s, e in layout)
          + f"; {other} other kernels; host all_reduce records {len(host)}")
    world = dist.get_world_size()
    laid = all(nccl[c][1] != k3[c + 1][1] and nccl[c][2] >= k3[c + 1][3]
               for c in range(min(len(nccl), chunks)))
    print(f"parallel: {len(nccl)} NCCL kernels in a world of {world} "
          + ("(a one-rank all_reduce runs no kernel: NCCL returns it as a "
             "no-op, so the layout has only the K3 launches)"
             if world == 1 and not nccl else
             f"each on a stream of its own after its chunk's K3 launch: "
             f"{'yes' if laid and len(nccl) == chunks else 'no'}"))
    if len(k3) != 1 + chunks:
        problems.append(f"the trace holds {len(k3)} K3 launches")
    if len(host) != chunks:
        problems.append(f"the trace holds {len(host)} host all_reduce "
                        "records")
    if (world > 1 or nccl) and not (laid and len(nccl) == chunks):
        problems.append("the NCCL kernels are not laid out one a chunk "
                        "after its K3 launch on their own stream")
    out["tp"] = {"launches": launches, "worst_over_bound": worst,
                 "block_rel": block, "issued": issued,
                 "layout": [list(r) for r in layout],
                 "other_kernels": other, "host_all_reduce": len(host)}
    rows = [tp_k3_row("tp_mlp_block up", x, up8, up_s, torch.bfloat16, 1,
                      errs["up"])]
    hc = seen[1][0]
    rows.append(tp_k3_row("tp_mlp_block down chunk", hc, down_c[0],
                          down_s[:csz], torch.float32, chunks, errs["down"]))
    return rows


def parallel_wire(out, problems):
    """wire_all_reduce_tree over the train_lm preset's gradient tree on the
    card (NCCL) against the same call on the CPU (a gloo group), timed."""
    import torch
    import torch.distributed as dist
    from fp8tpu_torch.parallel import wire_all_reduce_tree
    gen = torch.Generator("cuda").manual_seed(21)
    tree = {}
    for i, (name, shape, _) in enumerate(lm_shapes()):
        # each leaf its own magnitude, 1e-4 .. 1e1, as gradients of layers
        scale = 10.0 ** (-4 + 5 * ((i * 37) % 110) / 110)
        tree[name] = torch.randn(shape, device="cuda", generator=gen) * scale
    n = sum(t.numel() for t in tree.values())
    got = wire_all_reduce_tree(tree, None, "e4m3")
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: wire_all_reduce_tree(tree, None, "e4m3"), iters=5,
                 warmup=1)
    gloo = dist.new_group([0], backend="gloo")
    want = wire_all_reduce_tree({k: v.cpu() for k, v in tree.items()}, gloo,
                                "e4m3")
    bad = sum(bytes_differ(got[k].cpu(), want[k]) for k in tree)
    print(f"parallel: wire_all_reduce_tree (e4m3, blocks of 512) over the "
          f"train_lm preset's {len(tree)} leaves ({n} elements): {ms:.3f} "
          f"ms a call on the card ({4.0 * n / ms / 1e6:.1f} GB/s of f32 "
          f"gradient); {bad} bytes differ from the CPU's (gloo) result (0 "
          f"required)")
    if bad:
        problems.append(f"wire_all_reduce_tree: {bad} bytes off the CPU's")
    out["wire"] = {"elements": n, "leaves": len(tree), "ms": ms,
                   "bytes_differ": bad}


def parallel_dp(out, problems):
    """The train_lm trainer's data-parallel step (world of one) against the
    non-parallel step over train_lm's batches: parameters bit-equal."""
    import torch
    from fp8tpu_torch.kernels import adam8, cast_kernel
    from fp8tpu_torch.numerics import prng
    from fp8tpu_torch.parallel import BatchShard, make_mesh
    key = prng.key(1)
    batches = lm_batches(1 + LM_STEPS)
    runs = {}
    for dp in (False, True):
        shard = BatchShard.of(make_mesh(data=1).group("data")) if dp \
            else None
        _, _, params, opt, step, state = lm_trainer(shard=shard)
        adam8.reset_launches()
        cast_kernel.reset_launches()
        params, state, losses, times, _ = lm_run(step, params, state,
                                                 batches, key)
        runs[dp] = ({n: p.detach().clone() for n, p in params.items()},
                    losses, state[1], times,
                    {"adam8_update": adam8.launches,
                     "cast_kernel": cast_kernel.launches})
        del params, opt, step, state
        torch.cuda.empty_cache()
    (p0, l0, s0, t0, _), (p1, l1, s1, t1, launches) = runs[False], runs[True]
    bad = sum(bytes_differ(p1[n], p0[n]) for n in p0)
    ms0 = 1000.0 * sum(t0[1:]) / LM_STEPS
    ms1 = 1000.0 * sum(t1[1:]) / LM_STEPS
    print(f"parallel: train_lm's {len(batches)} steps with the "
          f"data-parallel step (world of one): losses "
          f"{'equal' if l1 == l0 else (l1, l0)}, loss scale {s1} / {s0}, "
          f"{bad} parameter bytes differ from the non-parallel step's (0 "
          f"required); launches {launches} ({len(batches)} each "
          f"required); {ms1:.2f} ms/step against {ms0:.2f}")
    if bad or l1 != l0 or s1 != s0:
        problems.append(f"the data-parallel step: {bad} bytes, losses "
                        f"{l1} vs {l0}")
    if launches != {"adam8_update": len(batches),
                    "cast_kernel": len(batches)}:
        problems.append(f"the data-parallel step's launches {launches}")
    out["dp"] = {"bytes_differ": bad, "losses": l1, "launches": launches,
                 "ms_per_step": ms1, "ms_per_step_single": ms0}


def pp_stage(params, x):
    """The quantized stage of tests/test_pipeline_moe.py at PP_WIDTH: e4m3
    per-tensor casts (K1) of both weights and the input, tanh GELU."""
    import torch
    import torch.nn.functional as F
    from fp8tpu_torch._device import full_fp32
    from fp8tpu_torch.quant.config import TensorQuantConfig
    from fp8tpu_torch.quant.fakequant import fake_quant
    cfg = TensorQuantConfig(dtype="e4m3", scheme="rne",
                            scaling="per-tensor-max")
    with full_fp32():
        h = F.gelu(fake_quant(x, cfg) @ fake_quant(params["w1"], cfg),
                   approximate="tanh")
        return x + h @ fake_quant(params["w2"], cfg)


def parallel_pp_moe(out, problems):
    """pipeline_apply at one stage and moe_ffn over a one-rank mesh, each
    against its plain counterpart, outputs and gradients."""
    import torch
    from fp8tpu_torch.kernels import cast_kernel
    from fp8tpu_torch.numerics import cast as cast_mod
    from fp8tpu_torch._device import full_fp32
    from fp8tpu_torch.parallel import (make_mesh, make_pp_mesh, moe_ffn,
                                       pipeline_apply,
                                       quantize_expert_weights, top_k_routing)
    gen = torch.Generator("cuda").manual_seed(22)
    d = PP_WIDTH

    def leaves():
        return {"w1": (torch.randn(1, d, d, device="cuda", generator=g0)
                       * d ** -0.5).requires_grad_(True),
                "w2": (torch.randn(1, d, d, device="cuda", generator=g0)
                       * d ** -0.5).requires_grad_(True)}

    g0 = torch.Generator("cuda").manual_seed(23)
    pp_params = leaves()
    g0.manual_seed(23)
    plain_params = leaves()
    x = torch.randn(PP_ROWS, d, device="cuda", generator=gen)
    cast_kernel.reset_launches()
    with _Counting(cast_mod, "qdq_plain", forbid=True):
        y = pipeline_apply(pp_stage, pp_params, x, make_pp_mesh(1, 1),
                           n_microbatches=PP_MICRO)
        torch.cuda.synchronize()
    k1 = cast_kernel.launches
    (y ** 2).mean().backward()
    mbs = x.reshape(PP_MICRO, -1, d)
    stage0 = {k: v[0] for k, v in plain_params.items()}
    ref = torch.cat([pp_stage(stage0, mb) for mb in mbs])
    (ref ** 2).mean().backward()
    pp_bad = bytes_differ(y, ref) + sum(
        bytes_differ(pp_params[k].grad, plain_params[k].grad)
        for k in pp_params)
    # one of the path's K1 casts against the plain cast on the CPU
    from fp8tpu_torch.numerics.formats import RoundMode
    from fp8tpu_torch.numerics.scaling import per_tensor
    s = per_tensor(mbs[0], "e4m3")
    k1_bad = bytes_differ(
        cast_kernel.cuda_qdq(mbs[0], "e4m3", RoundMode.RNE, s).cpu(),
        cast_mod.qdq_plain(mbs[0].cpu(), "e4m3", RoundMode.RNE, s.cpu()))
    print(f"parallel: pipeline_apply, 1 stage of {d} x {d} (e4m3 casts), "
          f"{PP_ROWS} rows in {PP_MICRO} microbatches: K1 launches {k1} "
          f"({3 * PP_MICRO} required), no plain cast; output and gradients "
          f"against the stage run microbatch by microbatch: {pp_bad} bytes "
          f"differ (0 required); a stage input's K1 cast against the plain "
          f"cast on the CPU: {k1_bad} bytes differ (0 required)")
    if pp_bad or k1_bad or k1 != 3 * PP_MICRO:
        problems.append(f"pipeline_apply: {pp_bad} / {k1_bad} bytes, {k1} "
                        "K1 launches")

    t, dm, dff, e = (MOE_PAR[n] for n in ("tokens", "d_model", "d_ff",
                                          "experts"))
    xm = torch.randn(t, dm, device="cuda", generator=gen)
    gate = torch.randn(dm, e, device="cuda", generator=gen) * dm ** -0.5
    up8, up_s = quantize_expert_weights(
        torch.randn(e, dm, dff, device="cuda", generator=gen) * dm ** -0.5)
    down8, down_s = quantize_expert_weights(
        torch.randn(e, dff, dm, device="cuda", generator=gen) * dff ** -0.5)
    cap = max(int(1.25 * 2 * t / e), 2)        # moe_ffn's capacity
    with torch.no_grad(), full_fp32():
        filled = int(top_k_routing(xm @ gate, 2, cap)[0].sum())
    res = []
    for mesh in (None, make_mesh(model=1)):
        leaves_ = [a.clone().requires_grad_(True)
                   for a in (xm, gate, up_s, down_s)]
        ym, aux = moe_ffn(leaves_[0], leaves_[1], up8, leaves_[2], down8,
                          leaves_[3], mesh=mesh)
        ((ym ** 2).sum() + 0.01 * aux).backward()
        res.append([ym.detach(), aux.detach()] + [a.grad for a in leaves_])
    moe_bad = sum(bytes_differ(a, b) for a, b in zip(*res))
    print(f"parallel: moe_ffn over a one-rank mesh ({t} tokens, d_model "
          f"{dm}, {e} experts of d_ff {dff}, top-2, e4m3; {filled} of "
          f"{e * cap} expert slots filled): "
          f"output, aux and gradients against mesh=None: {moe_bad} bytes "
          f"differ (0 required)")
    if moe_bad:
        problems.append(f"moe_ffn over a mesh: {moe_bad} bytes")
    out["pp_moe"] = {"pp_bytes": pp_bad, "k1_launches": k1,
                     "k1_bytes": k1_bad, "moe_bytes": moe_bad,
                     "moe_slots_filled": filled}


def phase_parallel(record):
    """fp8tpu_torch.parallel over NCCL in a world of one: returns the K3
    rows of the kernels record."""
    import torch.distributed as dist
    from fp8tpu_torch.parallel import init_world
    init_world("cuda")
    out, problems = {}, []
    try:
        rows = parallel_tp(out, problems)
        parallel_wire(out, problems)
        parallel_dp(out, problems)
        parallel_pp_moe(out, problems)
    finally:
        dist.destroy_process_group()
    record["parallel"] = out
    if problems:
        raise PhaseError("; ".join(problems))
    return rows


# -- phase tp: tensor parallelism inside the decoder, a world of one ----------

TP_PTQ_TOKENS = (4, 128)       # 7a's batch: 4 sequences of 128 tokens
TP_LOGIT_TOL = 2e-3            # 7a against the unsharded forward, of max|logit|
TP_REQUESTS, TP_NEW = 8, 16    # 7b: requests through each engine, new tokens
TP_SPLITS = (4, 8)             # model axes whose shard shapes (c) runs
TP_M = SERVE_SLOTS             # rows of (c)'s K3 launches: a decode step
TP_K4_POS = 444                # (c)'s K4 context (SPEC_POS)


def tp_config():
    """bench.py's CFG: the serve cell's widths (16 layers, d_model 4096,
    32 / 8 heads, d_ff 11008, vocabulary 32768); the emulation Decoder of
    7a in bf16 has about 2.95 B parameters."""
    return serve_config()


def _tp_requests():
    import dataclasses
    return [dataclasses.replace(r, max_new_tokens=TP_NEW)
            for r in serve_requests(21, TP_REQUESTS, tp_config().vocab_size)]


def tp_ptq(out, problems, mesh):
    """7a: the TP quantized_apply (e4m3 PTQ) on a data 1 x model 1 mesh
    against the unsharded one: weights bit for bit, logits within
    TP_LOGIT_TOL; K1's launches on the path counted, and K1 at the path's
    largest shape (the embedding's per-row cast) against its plain
    version.  Returns the K1 row of the kernels record."""
    import torch
    from fp8tpu_torch.kernels import cast_kernel
    from fp8tpu_torch.models.transformer import Decoder, decoder
    from fp8tpu_torch.numerics import cast as cast_mod
    from fp8tpu_torch.numerics.formats import RoundMode
    from fp8tpu_torch.numerics.scaling import per_channel
    from fp8tpu_torch.parallel import DECODER_PARAM_RULES, local_shards
    from fp8tpu_torch.quant import interceptor as icp
    from fp8tpu_torch.quant.policy import e4m3_inference_policy
    from fp8tpu_torch.tools import device_ms
    cfg = tp_config()
    pol = e4m3_inference_policy()
    gen = torch.Generator("cuda").manual_seed(21)
    t0 = time.perf_counter()
    full = decoder(cfg, "cuda", gen)
    sd = {k: v.detach() for k, v in full.state_dict().items()}
    n_params = sum(v.numel() for v in sd.values())
    table = icp.build_module_table(full)
    with torch.device("meta"):
        tpm = Decoder(cfg, mesh=mesh)
    local = local_shards(sd, mesh, DECODER_PARAM_RULES, table)
    shards = icp.weight_shards(tpm, mesh)
    b, s = TP_PTQ_TOKENS
    toks = torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                         generator=gen)
    torch.cuda.synchronize()
    made = time.perf_counter() - t0

    # the main path: counts from 0, no plain cast allowed
    cast_kernel.reset_launches()
    with torch.no_grad(), _Counting(cast_mod, "qdq_plain", forbid=True):
        t = time.perf_counter()
        got = icp.quantized_apply(tpm, pol, toks, params=local, mesh=mesh)
        torch.cuda.synchronize()
        tp_s = time.perf_counter() - t
    k1 = cast_kernel.launches
    with torch.no_grad():
        t = time.perf_counter()
        want = icp.quantized_apply(full, pol, toks, params=sd)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t
        rel = float((got - want).abs().max() / want.abs().max())
        differ = int((got != want).sum())
        # the weights, one at a time: the TP casts (shards and their
        # groups) against the unsharded quantize_params
        wbad = 0
        for name, tensor in local.items():
            a = icp.quantize_params({name: tensor}, pol, table, None, shards)
            w = icp.quantize_params({name: sd[name]}, pol, table)
            wbad += bytes_differ(a[name], w[name])
            del a, w
    # wall (a warm call) and device ms of both forwards
    with torch.no_grad():
        prof, wall = {}, {}
        for label, fn in (("tp", lambda: icp.quantized_apply(
                tpm, pol, toks, params=local, mesh=mesh)),
                          ("unsharded", lambda: icp.quantized_apply(
                              full, pol, toks, params=sd))):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall[label] = (time.perf_counter() - t) * 1e3
            p = open_profile(fn)
            prof[label] = sum(
                (getattr(e, "device_time", None) or e.cuda_time) / 1e3
                for e in p.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and LEAD_KERNEL not in e.name)
    print(f"tp (a): the e4m3 PTQ forward of the emulation Decoder ({n_params / 1e9:.3f} B "
          f"parameters from a seed, made in {made:.1f} s; {b} x {s} tokens) "
          f"on a data 1 x model 1 mesh: K1 launches {k1} (weights and "
          f"activations), no plain cast; weights against the unsharded "
          f"quantize_params: {wbad} bytes differ (0 required); logits "
          f"against the unsharded forward {rel:.3e} of max|logit| (limit "
          f"{TP_LOGIT_TOL}), {differ} of {got.numel()} differ; wall "
          f"{tp_s * 1e3:.1f} ms (first call) against {plain_s * 1e3:.1f} ms, "
          f"warm {wall['tp']:.1f} ms against {wall['unsharded']:.1f} ms, "
          f"device {prof['tp']:.2f} ms against {prof['unsharded']:.2f} ms")
    if wbad or not rel <= TP_LOGIT_TOL or not bool(torch.isfinite(got).all()):
        problems.append(f"the TP PTQ forward: {wbad} weight bytes, logits "
                        f"{rel} of max")
    if k1 == 0:
        problems.append("the TP PTQ forward launched no K1")

    # K1 at the path's largest shape: the embedding's per-row e4m3 cast,
    # against the plain version on the card, and its first 2048 rows on the
    # CPU, which decides
    emb = sd["embed.embedding"]
    sc = per_channel(emb, "e4m3", "max", 0)
    k_out = cast_kernel.cuda_qdq(emb, "e4m3", RoundMode.RNE, sc)
    p_out = cast_mod.qdq_plain(emb, "e4m3", RoundMode.RNE, sc)
    bad = bits_equal(k_out, p_out)
    rows = slice(0, 2048)
    cpu = cast_mod.qdq_plain(emb[rows].cpu(), "e4m3", RoundMode.RNE,
                             sc[rows].cpu())
    bad_cpu = bits_equal(k_out[rows].cpu(), cpu)
    err = float((k_out - p_out).abs().max())
    t_k = device_ms(lambda: cast_kernel.cuda_qdq(emb, "e4m3", RoundMode.RNE,
                                                 sc), iters=4, replays=3)
    t_p = cuda_ms(lambda: cast_mod.qdq_plain(emb, "e4m3", RoundMode.RNE, sc),
                  iters=2, warmup=1)
    bound = (8.0 * emb.numel() + 4.0 * sc.numel()) / HBM_BYTES_PER_S * 1e3
    print(f"tp (a): K1 at the path's largest shape {tuple(emb.shape)} "
          f"(e4m3, per-row scales): {bad} elements differ from the plain "
          f"version on the card, {bad_cpu} of its first 2048 rows from the "
          f"plain version on the CPU (0 required); kernel {t_k:.4f} ms, "
          f"plain {t_p:.4f} ms, bound {bound:.4f} ms (bytes), no PyTorch "
          f"call computes this cast")
    if bad or bad_cpu:
        problems.append(f"K1 at the embedding: {bad} / {bad_cpu} elements")
    out["ptq"] = {"parameters": n_params, "k1_launches": k1,
                  "weight_bytes_differ": wbad, "logit_rel": rel,
                  "logits_differ": differ, "wall_ms": tp_s * 1e3,
                  "wall_ms_unsharded": plain_s * 1e3,
                  "warm_wall_ms": wall["tp"],
                  "warm_wall_ms_unsharded": wall["unsharded"],
                  "device_ms": prof["tp"],
                  "device_ms_unsharded": prof["unsharded"],
                  "k1_largest": {"shape": list(emb.shape), "bad": bad,
                                 "bad_cpu": bad_cpu, "ms": t_k,
                                 "plain_ms": t_p, "bound_ms": bound}}
    del full, sd, local, tpm, got, want, emb, sc, k_out, p_out
    torch.cuda.empty_cache()
    return {"name": "cast_kernel (TP PTQ forward, embedding 32768 x 4096 "
                    "per-row e4m3)",
            "route": "cuda",
            "source": "fp8tpu_torch/kernels/csrc/cast_kernel.cu",
            "replaces": "fp8tpu/kernels/cast_kernel.py:45",
            "launches": k1, "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None}


def _tp_engine(params, scfg, mesh, spec=False, server=False):
    """Answer _tp_requests() through a ServingEngine (self-draft paged with
    spec, the ring otherwise), over ``mesh`` or unsharded, behind an
    EngineServer with ``server``: ({uid: tokens}, seconds, the engine)."""
    from fp8tpu_torch.serve import EngineServer, ServingEngine
    kw = dict(use_paged=True, page_size=PAGE, draft_params=params,
              draft_cfg=scfg, k_spec=3) if spec else {}
    eng = ServingEngine(params, scfg, n_slots=SERVE_SLOTS, max_seq=SERVE_SEQ,
                        chunk_size=16, mesh=mesh, **kw)
    t0 = time.perf_counter()
    if not server:
        return eng.run(_tp_requests()), time.perf_counter() - t0, eng
    srv = EngineServer(eng).start()
    try:
        futs = {r.uid: srv.submit(r) for r in _tp_requests()}
        res = {uid: f.result(timeout=600) for uid, f in futs.items()}
    finally:
        srv.stop()
    return res, time.perf_counter() - t0, eng


def _tp_held_k3(calls, sms):
    """Every recorded K3 launch against its plain version (gemm_tolerance)
    and the f64 product over the loop's promoted chunks
    (stream_reference): (launches, worst err / bound, max |err|)."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    worst, err = 0.0, 0.0
    for a, kw, got in calls:
        x, w8, s, od = a
        m, k = x.shape
        n = w8.shape[1]
        want = qmatmul.dequant_matmul_plain(x, w8, s, od)
        col = s.reshape(1, -1)
        tol = gemm_tolerance(x, w8.float().abs(), col, want, od)
        d = (got.float() - want.float()).abs()
        worst = max(worst, float((d / tol).max()))
        err = max(err, float(d.max()))
        plan = qmatmul.weight_gemm_plan(m, n, k, sms, "w8", x, w8)
        if plan.route != "general":
            exact, allowed = stream_reference(x, w8.float(), col, plan.kper,
                                              od)
            worst = max(worst, k2_ratio(got, exact, allowed))
    return len(calls), worst, err


def tp_serve(out, problems, mesh):
    """7b: the ring engine behind an EngineServer and the self-draft paged
    engine (K4's page walk) over the mesh against the unsharded engines;
    one sharded decode step's K3 and K6 launches (ring) and K4 launches
    (paged) against their plain versions; a sharded decode step's wall and
    device ms beside the unsharded one's.  Returns the path's launches."""
    import dataclasses
    import torch
    from fp8tpu_torch.kernels import inplace, qmatmul
    from fp8tpu_torch.kernels import paged_attention as k4
    from fp8tpu_torch.serve import (PagedKVCache, RingKVCache, ServeConfig,
                                    decode_step, decode_step_paged,
                                    decode_steps, prefill_batch,
                                    prefill_batch_paged, random_serve_params,
                                    shard_serve_params)
    from fp8tpu_torch.serve.model import local_heads
    cfg = tp_config()
    L = cfg.n_layers
    scfg = ServeConfig(model=cfg, weight_fmt="e4m3", kv_fmt="int8")
    kcfg = dataclasses.replace(scfg, paged_decode_impl="kernel")
    params = STATE.get("e4m3") or random_serve_params(cfg, "e4m3", seed=0)
    sp = shard_serve_params(params, scfg, mesh)

    # the main path: counts from 0, no plain version allowed
    for mod in (qmatmul, inplace, k4):
        mod.reset_launches()
    forbid = [_Counting(qmatmul, "dequant_matmul_plain", forbid=True),
              _Counting(inplace, "ring_store_plain", forbid=True),
              _Counting(k4, "paged_decode_attention_plain", forbid=True)]
    for c in forbid:
        c.__enter__()
    try:
        ring_tp, ring_s, _ = _tp_engine(sp, scfg, mesh, server=True)
        spec_tp, spec_s, eng = _tp_engine(sp, kcfg, mesh, spec=True)
        torch.cuda.synchronize()
    finally:
        for c in forbid:
            c.__exit__()
    launches = {"dequant_matmul": qmatmul.dequant_launches,
                "ring_store": inplace.routes["ring_store"],
                "paged_decode_attention": k4.launches}
    acc, drafted = eng.spec_accepted, eng.spec_drafted
    ring_ref, ring_rs, _ = _tp_engine(params, scfg, None, server=True)
    spec_ref, spec_rs, ref_eng = _tp_engine(params, kcfg, None, spec=True)
    # warm runs of the sharded engines, for their seconds
    _, ring_s, _ = _tp_engine(sp, scfg, mesh, server=True)
    _, spec_s, _ = _tp_engine(sp, kcfg, mesh, spec=True)
    ok_ring, ok_spec = ring_tp == ring_ref, spec_tp == spec_ref
    print(f"tp (b): {TP_REQUESTS} requests x {TP_NEW} tokens through the "
          f"ring engine behind an EngineServer over the mesh: tokens "
          f"{'equal to' if ok_ring else 'NOT equal to'} the unsharded "
          f"engine's ({ring_s:.2f} s against {ring_rs:.2f} s, each after a "
          f"run of its own); the "
          f"self-draft paged engine (K4, k_spec 3) over the mesh: tokens "
          f"{'equal to' if ok_spec else 'NOT equal to'} the unsharded "
          f"one's, {acc} of {drafted} drafts accepted (unsharded "
          f"{ref_eng.spec_accepted} of {ref_eng.spec_drafted}) "
          f"({spec_s:.2f} s against {spec_rs:.2f} s); launches {launches}, "
          f"no plain version called")
    if not (ok_ring and ok_spec):
        problems.append("a sharded engine's tokens differ from the "
                        "unsharded engine's")
    if (acc, drafted) != (ref_eng.spec_accepted, ref_eng.spec_drafted):
        problems.append("the sharded self-draft's acceptance differs")
    if not all(launches.values()):
        problems.append(f"a kernel of the serving path never launched: "
                        f"{launches}")

    # one sharded decode step, each launch held against its plain version
    gen = torch.Generator(device="cuda").manual_seed(22)
    B, kvl = SERVE_SLOTS, local_heads(sp, cfg)[1]
    prompts = torch.randint(1, cfg.vocab_size, (B, 32), device="cuda",
                            generator=gen, dtype=torch.int32)
    lengths = torch.randint(8, 33, (B,), device="cuda", generator=gen,
                            dtype=torch.int32)
    slots = torch.arange(B, device="cuda", dtype=torch.int32)
    zeros_f = torch.zeros(B, device="cuda")
    zeros_i = torch.zeros(B, device="cuda", dtype=torch.int32)
    ring = RingKVCache.create(L, B, SERVE_SEQ, kvl, cfg.head_dim, "int8")
    _, ring, toks, pos = prefill_batch(sp, ring, prompts, slots, lengths,
                                       None, zeros_f, None, None, zeros_i,
                                       zeros_i, scfg)
    before = RingKVCache(ring.kv8.clone(), ring.sc.clone(), ring.head.clone())
    with _Recording(qmatmul, "dequant_matmul") as rk3, \
            _Recording(inplace, "ring_store") as rk6:
        decode_step(sp, ring, toks, pos, scfg)
        torch.cuda.synchronize()
    n3, worst3, err3 = _tp_held_k3(rk3.calls, qmatmul.sm_count(0))
    (_, slab8, _, slabs, _, S, _), kw6, _ = rk6.calls[0]
    inplace.ring_store_plain(before.kv8, slab8, before.sc, slabs,
                             before.head, S, rows=kw6.get("rows", 1))
    bad6 = (bytes_differ(ring.kv8, before.kv8)
            + bytes_differ(ring.sc, before.sc)
            + int(int(ring.head) != int(before.head)))
    MP = SERVE_SEQ // PAGE
    paged = PagedKVCache.create(B * MP, PAGE, L, B, MP, kvl, cfg.head_dim,
                                "int8")
    paged.page_table = torch.arange(B * MP, device="cuda", dtype=torch.int32
                                    ).reshape(B, MP)
    _, paged, ptoks, ppos = prefill_batch_paged(
        sp, paged, prompts, slots, lengths, None, zeros_f, None, None,
        zeros_i, zeros_i, kcfg)
    checks = []
    with _CheckedK4(checks):
        decode_step_paged(sp, paged, ptoks, ppos, kcfg)
        torch.cuda.synchronize()
    bad4 = sum(not c["ok"] for c in checks)
    worst4 = max(c["err_over_bound"] for c in checks)
    print(f"tp (b): one sharded ring decode step: {n3} K3 launches ({7 * L} "
          f"required: 5 column-parallel and 2 row-parallel with f32 output "
          f"a layer), worst err / K3's bound {worst3:.3e} (<= 1 required); "
          f"the K6 ring write against ring_store_plain: {bad6} bytes differ "
          f"(0 required); one sharded paged step: {len(checks)} K4 launches "
          f"on {kvl} KV heads a slot, {bad4} outside k4_reference's bounds, "
          f"worst acc err / bound {worst4:.3e}")
    if n3 != 7 * L or worst3 > 1.0 or bad6 or bad4 or len(checks) != L:
        problems.append(f"a sharded decode step's launches: K3 {n3} / "
                        f"{worst3}, K6 {bad6}, K4 {len(checks)} / {bad4}")

    # a decode step's wall and device ms, sharded and not (batch 8, chunks
    # of one step from the prefilled ring)
    steps = {}
    temp = torch.zeros(B, device="cuda")
    for label, prm in (("tp", sp), ("unsharded", params)):
        r = RingKVCache(ring.kv8.clone(), ring.sc.clone(), ring.head.clone())

        def one(prm=prm, r=r):
            return decode_steps(prm, r, toks, pos, None, temp, 1, scfg,
                                greedy_only=True)

        one()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(8):
            one()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) / 8 * 1e3
        steps[label] = profile_decode_step(one, ms)
    print(f"tp (b): a decode step at batch {B} (ring): sharded "
          f"{steps['tp']['step_ms']:.2f} ms wall, "
          f"{steps['tp']['device_ms']:.2f} ms of kernels in "
          f"{steps['tp']['launches']} launches; unsharded "
          f"{steps['unsharded']['step_ms']:.2f} ms wall, "
          f"{steps['unsharded']['device_ms']:.2f} ms in "
          f"{steps['unsharded']['launches']} launches")
    out["serve"] = {"ring_equal": ok_ring, "spec_equal": ok_spec,
                    "spec_accepted": acc, "spec_drafted": drafted,
                    "seconds": [ring_s, ring_rs, spec_s, spec_rs],
                    "launches": launches, "k3_step": [n3, worst3, err3],
                    "k6_step_bytes": bad6, "k4_step": checks,
                    "step": {k: {kk: v[kk] for kk in ("step_ms", "device_ms",
                                                      "launches")}
                             for k, v in steps.items()}}
    del sp, ring, before, paged
    torch.cuda.empty_cache()
    return launches, err3, params


def tp_shapes(out, problems, launches, params):
    """(c) K3 at the shard shapes of a model-4 and a model-8 split of the
    serve cell (column shards of q / gate / up, bf16 out; row shards of o /
    down with f32 out and unit scales, as the row-parallel linear runs
    them) and K4 on KV / T heads, each against its plain version and timed
    by graph replay beside the unsharded launch.  Returns kernels rows."""
    import torch
    from fp8tpu_torch.kernels import paged_attention as k4
    from fp8tpu_torch.kernels import qmatmul
    from fp8tpu_torch.tools import device_ms
    cfg = tp_config()
    gen = torch.Generator(device="cuda").manual_seed(23)
    x_of = {}
    rows, worst = [], 0.0
    sms = qmatmul.sm_count(0)
    cases = []
    for T in (1,) + TP_SPLITS:
        for key, kind in (("q8", "col"), ("gate8", "col"), ("o8", "row"),
                          ("down8", "row")):
            w = params[key][0]
            k, n = w.shape
            w = w[:, :n // T] if kind == "col" else w[:k // T]
            w = w.contiguous()
            cases.append((T, key, kind, w))
    for T, key, kind, w in cases:
        k, n = w.shape
        if k not in x_of:
            x_of[k] = torch.randn(TP_M, k, device="cuda", generator=gen
                                  ).to(torch.bfloat16)
        x = x_of[k]
        if kind == "col":
            s = params[key.replace("8", "s")][0][:n].contiguous()
            od = torch.bfloat16
        else:
            s = torch.ones(n, device="cuda")
            od = torch.float32
        got = qmatmul.dequant_matmul(x, w, s, od)
        n_, w_, e_ = _tp_held_k3([((x, w, s, od), {}, got)], sms)
        worst = max(worst, w_)
        label = (f"{'unsharded' if T == 1 else f'model {T}'} {kind} "
                 f"{key[:-1]}")
        rows.append(tp_k3_row(label, x, w, s, od,
                              launches["dequant_matmul"], e_, "tp (c)"))
    print(f"tp (c): K3 at {len(cases)} shapes (unsharded and the model 4 / "
          f"8 shards of q, gate, o, down at M = {TP_M}): worst err / K3's "
          f"bound {worst:.3e} (<= 1 required)")
    if worst > 1.0:
        problems.append(f"K3 at a shard shape: {worst} of its bound")
    # K4 on KV / T heads: 8 slots at position TP_K4_POS, int8 pool
    D, KV, G = cfg.head_dim, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    MP = SERVE_SEQ // PAGE
    lens = torch.full((SERVE_SLOTS,), TP_K4_POS, device="cuda",
                      dtype=torch.int32)
    table = torch.arange(SERVE_SLOTS * MP, device="cuda", dtype=torch.int32
                         ).reshape(SERVE_SLOTS, MP)
    k4_rows = []
    for T in (1,) + TP_SPLITS:
        kv = KV // T
        pool = torch.randint(-127, 128, (SERVE_SLOTS * MP, 2, 1, PAGE * kv,
                                         D), device="cuda", generator=gen,
                             dtype=torch.int8)
        sc = torch.empty(pool.shape[:-1], device="cuda").uniform_(
            0.004, 0.02, generator=gen)
        q = (torch.randn(SERVE_SLOTS, kv * G, D, device="cuda", generator=gen)
             * 0.7).to(torch.bfloat16)
        args = (q, pool, sc, table, lens, 0)
        kw = dict(page_size=PAGE, kv_heads=kv)
        acc, m, l = k4.paged_decode_attention(*args, **kw)
        acc_p, m_p, l_p = k4.paged_decode_attention_plain(*args, **kw)
        _, _, _, m_tol, l_tol, acc_tol = k4_reference(*args, kv=kv,
                                                      page=PAGE)
        ok = bool(((m - m_p).abs() <= m_tol).all()
                  and ((l - l_p).abs() <= l_tol).all()
                  and ((acc - acc_p).abs() <= acc_tol).all())
        err = float((acc - acc_p).abs().max())
        t_k = device_ms(lambda: k4.paged_decode_attention(*args, **kw))
        t_p = cuda_ms(lambda: k4.paged_decode_attention_plain(*args, **kw),
                      iters=3, warmup=1)
        tokens = int(lens.sum())
        nbytes = (tokens * kv * (2 * D + 2 * 4) + table.numel() * 4
                  + lens.numel() * 4 + q.numel() * 2
                  + SERVE_SLOTS * kv * G * (D + 2) * 4)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2.0 * 2 * tokens * kv * G * D / F32_SIMT_FLOPS * 1e3
        safe, Tt, B = table.long(), MP * PAGE, SERVE_SLOTS
        mask = (torch.arange(Tt, device="cuda")[None] < lens[:, None]
                )[:, None, :].repeat_interleave(kv, 0)

        def library():
            kk = pool[safe, 0, 0].to(torch.bfloat16).reshape(B, Tt, kv, D)
            vv = pool[safe, 1, 0].to(torch.bfloat16).reshape(B, Tt, kv, D)
            ks = sc[safe, 0, 0].reshape(B, Tt, kv).permute(0, 2, 1)
            vs = sc[safe, 1, 0].reshape(B, Tt, kv).permute(0, 2, 1)
            s_ = torch.bmm(q.reshape(B * kv, G, D),
                           kk.permute(0, 2, 3, 1).reshape(B * kv, D, Tt),
                           out_dtype=torch.float32) * ks.reshape(B * kv, 1,
                                                                 Tt)
            s_ = torch.where(mask, s_, -1e30)
            mm = s_.amax(-1)
            p = torch.exp(s_ - mm[..., None])
            pv = (p * vs.reshape(B * kv, 1, Tt)).to(torch.bfloat16)
            return torch.bmm(pv, vv.permute(0, 2, 1, 3).reshape(B * kv, Tt,
                                                                D),
                             out_dtype=torch.float32), mm, p.sum(-1)

        t_l = device_ms(library)
        label = "unsharded" if T == 1 else f"model {T}"
        print(f"tp (c): K4 {label}: {kv} KV heads x {G} queries of {D}, "
              f"{SERVE_SLOTS} slots x {TP_K4_POS} tokens (int8): within "
              f"k4_reference's bounds {ok}, kernel {t_k:.5f} ms, plain "
              f"{t_p:.4f} ms, bound {max(t_bytes, t_ops):.5f} ms, gather + "
              f"upcast + torch.bmm {t_l:.5f} ms")
        if not ok:
            problems.append(f"K4 on {kv} KV heads outside its bounds")
        k4_rows.append({
            "name": f"paged_decode_attention (TP {label}, {kv} KV heads)",
            "route": "cuda",
            "source": "fp8tpu_torch/kernels/csrc/paged_attention.cu",
            "replaces": "fp8tpu/kernels/paged_attention.py:55",
            "launches": launches["paged_decode_attention"],
            "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": t_l})
        del pool, sc, q
    out["shapes"] = {"k3_worst_over_bound": worst,
                     "k3": [{k: r[k] for k in ("name", "ms", "plain_ms",
                                               "bound_ms", "library_ms")}
                            for r in rows],
                     "k4": [{k: r[k] for k in ("name", "ms", "plain_ms",
                                               "bound_ms", "library_ms")}
                            for r in k4_rows]}
    return rows + k4_rows


def tp_k6_row(launches, kv_heads):
    """K6's ring write of a sharded decode step (8 slots, the rank's KV
    heads, int8): kernel and plain timed, bytes bound."""
    import torch
    from fp8tpu_torch.kernels import inplace
    from fp8tpu_torch.tools import device_ms
    cfg = tp_config()
    gen = torch.Generator(device="cuda").manual_seed(24)
    bk = SERVE_SLOTS * kv_heads
    kv8 = torch.zeros((SERVE_SEQ, 2, cfg.n_layers, bk, cfg.head_dim),
                      dtype=torch.int8, device="cuda")
    sc = torch.ones(kv8.shape[:-1], device="cuda")
    slab8 = torch.randint(-127, 128, kv8.shape[1:], device="cuda",
                          generator=gen, dtype=torch.int8)
    slabs = torch.rand(sc.shape[1:], device="cuda", generator=gen)
    kv8_p, sc_p = kv8.clone(), sc.clone()
    head = torch.tensor(7, device="cuda", dtype=torch.int32)
    head_p = head.clone()
    ticket = torch.zeros(1, device="cuda", dtype=torch.int32)
    inplace.ring_store(kv8, slab8, sc, slabs, head, SERVE_SEQ, ticket)
    inplace.ring_store_plain(kv8_p, slab8, sc_p, slabs, head_p, SERVE_SEQ)
    err = max(float((kv8.short() - kv8_p.short()).abs().max()),
              float((sc - sc_p).abs().max()), abs(int(head) - int(head_p)))
    t_k = device_ms(lambda: inplace.ring_store(kv8, slab8, sc, slabs, head,
                                               SERVE_SEQ, ticket))
    t_p = device_ms(lambda: inplace.ring_store_plain(kv8_p, slab8, sc_p,
                                                     slabs, head_p,
                                                     SERVE_SEQ))
    nbytes = slab8.numel() + 4 * slabs.numel()
    b = 2.0 * nbytes / HBM_BYTES_PER_S * 1e3
    print(f"tp (b): K6 ring write of a sharded step ({kv_heads} KV heads a "
          f"slot, {nbytes} bytes): kernel {t_k:.5f} ms, plain {t_p:.5f} ms, "
          f"bound {b:.6f} ms (bytes), max |kernel - plain| {err}")
    return {"name": f"ring_store (TP ring, {kv_heads} KV heads a slot)",
            "route": "cuda", "source": "fp8tpu_torch/kernels/csrc/inplace.cu",
            "replaces": "fp8tpu/kernels/inplace.py:27",
            "launches": launches["ring_store"], "max_abs_err": err,
            "ms": t_k, "plain_ms": t_p, "bound_ms": b, "bound_by": "bytes",
            "library_ms": None}, err


# (d) the model-parallel FP8 training step (ROADMAP 7c) in the world of one
TP_TRAIN_BATCH = 8             # sequences of LM's 256 tokens a step
TP_TRAIN_STEPS = 3
TP_SR_SALT = 0x2545F491        # K1's block route checks: an SR salt
TP_P3_LEAF = (768, 2304)       # the large preset's gate kernel, Flax layout
TP_P3_SPLIT = 4                # its column shards (model 4)


def _train_state(params, opt, state):
    """Parameters, 8-bit moment bytes and scales, count and loss scale of a
    trainer, cloned."""
    return ({n: p.detach().clone() for n, p in params.items()},
            {n: [t.clone() for w in ("m", "v") for t in opt.state[p][w]]
             for n, p in params.items()}, opt.count, state[1])


def tp_train(out, problems, mesh):
    """(d) ``train_fp8 --training-algo hybrid-gemm --master-fmt fp16 --opt8
    --emb-fmt e4m3`` at the large preset's width (82.8M parameters, batch
    TP_TRAIN_BATCH x 256) over the data 1 x seq 1 x model 1 mesh for
    TP_TRAIN_STEPS steps against the plain step (no mesh): parameters,
    moment bytes, scales, losses and loss scales bit-equal; K1's and P3's
    launches counted, their plain versions forbidden.  Then hybrid with hw
    patching at LM_HW_LAYERS layers and batch LM_HW_BATCH over the mesh:
    the loss equal to the plain hw-patched step's, every K2 launch of the
    step within k2_reference.  Returns the main path's launches."""
    import torch
    from fp8tpu_torch.kernels import adam8, cast_kernel, qmatmul
    from fp8tpu_torch.models.transformer import DecoderConfig
    from fp8tpu_torch.numerics import cast as cast_mod
    from fp8tpu_torch.numerics import prng
    from fp8tpu_torch.tools.bench_tp import lm_tokens, run_steps, trainer
    from fp8tpu_torch.training.mpt import lm_batch
    dev = torch.device("cuda")
    cfg = DecoderConfig(**LM)
    toks = [lm_tokens(cfg, TP_TRAIN_BATCH, i, dev)
            for i in range(TP_TRAIN_STEPS)]
    key = prng.key(1)
    runs, launches = {}, {}
    for label, m in (("mesh", mesh), ("plain", None)):
        emu, params, opt, step, state = trainer(cfg, dev, m)
        adam8.reset_launches()
        cast_kernel.reset_launches()
        with _Counting(adam8, "adam8_update_plain", forbid=True), \
                _Counting(cast_mod, "qdq_plain", forbid=True):
            params, state, losses, secs = run_steps(
                step, params, state, [lm_batch(t, m) for t in toks], key,
                torch.cuda.synchronize)
        if label == "mesh":
            launches = {"cast_kernel": cast_kernel.launches,
                        "cast_kernel_block": cast_kernel.block_launches,
                        "adam8_update": adam8.launches,
                        "adam8_split": adam8.split_launches}
        runs[label] = (_train_state(params, opt, state), losses, secs)
        del emu, params, opt, step, state
        torch.cuda.empty_cache()
    (pm, mm, cm, sm), lm_, tm = runs["mesh"]
    (pp, mp, cp, sp), lp, tpl = runs["plain"]
    bad = sum(bytes_differ(pm[n], pp[n]) for n in pp)
    bad_m = sum(bytes_differ(a, b) for n in mp for a, b in zip(mm[n], mp[n]))
    same = lm_ == lp and cm == cp and sm == sp
    print(f"tp (d): the model-parallel step over data 1 x seq 1 x model 1, "
          f"large preset ({sum(t.numel() for t in pp.values())} parameters)"
          f", batch {TP_TRAIN_BATCH} x {LM['max_seq_len'] - 1}, "
          f"{TP_TRAIN_STEPS} steps: losses {lm_} (plain {lp}), loss scale "
          f"{sm} (plain {sp}); differing bytes: parameters {bad}, 8-bit "
          f"moments and scales {bad_m} (0 required); wall ms a step "
          f"{[round(1e3 * t, 2) for t in tm]} against plain "
          f"{[round(1e3 * t, 2) for t in tpl]}; launches {launches}")
    if bad or bad_m or not same:
        problems.append(f"the one-rank model-parallel step is not the plain "
                        f"step: {bad} / {bad_m} bytes, losses {lm_} / {lp}")
    if not launches["cast_kernel"] or not launches["adam8_update"]:
        problems.append(f"the model-parallel step's launches {launches}")
    del runs, pm, mm, pp, mp
    torch.cuda.empty_cache()

    # hybrid with hw patching over the mesh, LM_HW_LAYERS layers
    hcfg = DecoderConfig(**{**LM, "n_layers": LM_HW_LAYERS})
    batch = lm_tokens(hcfg, LM_HW_BATCH, 9, dev)
    hw_loss, checked = {}, []
    launch = qmatmul._launch

    def checking(*args, impl="bitexact", unsplit=False):
        got = launch(*args, impl=impl, unsplit=unsplit)
        checked.append(k2_launch_error(got, args, impl))
        return got

    for label, m in (("mesh", mesh), ("plain", None)):
        _, params, _, step, state = trainer(hcfg, dev, m, algo="hybrid",
                                            emb=None, hw=True)
        k0 = dict(qmatmul.k2_launches)
        if label == "mesh":
            qmatmul._launch = checking
        try:
            with _Counting(qmatmul, "plain", forbid=True):
                _, _, loss = step(params, state, lm_batch(batch, m),
                                  prng.fold_in(key, 7))
        finally:
            qmatmul._launch = launch
        hw_loss[label] = float(loss)
        if label == "mesh":
            k2 = {v: qmatmul.k2_launches[v] - k0[v] for v in k0}
            launches["qdq_matmul_prepass_block"] = k2["prepass_block"]
        del params, step, state
    slices = 2 * LM_HW_LAYERS * LM_HW_BATCH * LM["n_heads"]
    worst = max(checked, default=0.0)
    print(f"tp (d): hybrid with hw patching over the mesh, {LM_HW_LAYERS} "
          f"layers, batch {LM_HW_BATCH}: loss {hw_loss['mesh']:.7f} (plain "
          f"{hw_loss['plain']:.7f}); K2 launches {k2} ({slices} BatchMatmul "
          f"slices), each against k2_reference: worst {worst:.3e} of the "
          f"bound (<= 1 required)")
    if (hw_loss["mesh"] != hw_loss["plain"] or len(checked) != 2 * slices
            or worst > 1.0):
        problems.append(f"hw-patched model-parallel step: losses {hw_loss}, "
                        f"{len(checked)} K2 launches, worst {worst}")
    out["train"] = {"losses": lm_, "plain_losses": lp, "loss_scale": str(sm),
                    "bytes_differ": bad + bad_m, "step_ms": [1e3 * t
                                                             for t in tm],
                    "plain_step_ms": [1e3 * t for t in tpl],
                    "launches": launches, "hw_losses": hw_loss,
                    "hw_k2": k2, "hw_k2_worst": worst}
    return launches


def tp_k1_block_row(out, problems, launches):
    """K1's block route (e5m2 SR, hashing each element's global index)
    against its plain version, bit for bit: a column quarter of the
    (2048, 2304) gate-output gradient, a seq half of an (8, 256, 768)
    activation, and a contiguous row block (also bit-equal to the salt_at
    route).  The column block timed.  Returns its kernels row."""
    import torch
    from fp8tpu_torch.kernels import cast_kernel
    from fp8tpu_torch.numerics.cast import qdq_plain, salt_at
    from fp8tpu_torch.numerics.formats import RoundMode
    from fp8tpu_torch.parallel.data import Block
    from fp8tpu_torch.tools import device_ms
    gen = torch.Generator(device="cuda").manual_seed(25)
    sr = RoundMode.STOCHASTIC
    cases = (("column", (2048, 576), Block((2048, 2304), (0, 576))),
             ("seq", (8, 128, 768), Block((8, 256, 768), (0, 128, 0))),
             ("contiguous", (4, 256, 768), Block((8, 256, 768), (4, 0, 0))))
    rows, timed, checks = {}, None, 0
    for name, shape, blk in cases:
        x = torch.randn(shape, device="cuda", generator=gen) * 3.0
        # on the card: a graph replay copies nothing from the host
        scale = 57344.0 / x.abs().max()
        b0 = cast_kernel.block_launches
        got = cast_kernel.cuda_qdq(x, "e5m2", sr, scale, salt=TP_SR_SALT,
                                   block=blk)
        routed = cast_kernel.block_launches - b0
        checks += routed
        want = qdq_plain(x, "e5m2", sr, scale, salt=TP_SR_SALT, block=blk)
        bad = bytes_differ(got, want)
        row = {"shape": shape, "global": blk.shape, "start": blk.start,
               "bytes_differ": bad, "block_launches": routed}
        if name == "contiguous":
            off = blk.contiguous_offset(shape)
            row["salt_at_differ"] = bytes_differ(got, cast_kernel.cuda_qdq(
                x, "e5m2", sr, scale,
                salt=salt_at(TP_SR_SALT, off)))
            bad += row["salt_at_differ"]
        if bad or routed != 1:
            problems.append(f"K1's block route ({name}): {row}")
        rows[name] = row
        if name == "column":
            n = x.numel()
            timed = {
                "ms": device_ms(lambda: cast_kernel.cuda_qdq(
                    x, "e5m2", sr, scale, salt=TP_SR_SALT, block=blk)),
                "plain_ms": cuda_ms(lambda: qdq_plain(
                    x, "e5m2", sr, scale, salt=TP_SR_SALT, block=blk),
                    iters=3, warmup=1),
                "bound_ms": 8.0 * n / HBM_BYTES_PER_S * 1e3}
        del x, got, want
    print(f"tp (d): K1's block route against its plain version: "
          + "; ".join(f"{k} {v['shape']} of {v['global']} at {v['start']}: "
                      f"{v['bytes_differ']} differing bytes"
                      + (f", {v['salt_at_differ']} against the salt_at route"
                         if "salt_at_differ" in v else "")
                      for k, v in rows.items())
          + f" (0 required); the column block: kernel {timed['ms']:.5f} ms, "
          f"plain {timed['plain_ms']:.4f} ms, bytes bound "
          f"{timed['bound_ms']:.5f} ms")
    out["k1_block"] = {"cases": rows, "time": timed}
    return {"name": "fp8_cast_block (K1's block route: e5m2 SR of a column "
                    "quarter of the (2048, 2304) gate-output gradient, each "
                    "element's bits at its global index; off the one-card "
                    "main path, where a world of one holds every tensor "
                    "whole: check_launches are this check's)",
            "route": "cuda",
            "source": "fp8tpu_torch/kernels/csrc/cast_kernel.cu",
            "replaces": "fp8tpu/kernels/cast_kernel.py:45",
            "launches": launches["cast_kernel_block"],
            "check_launches": checks, "max_abs_err": 0.0,
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": "bytes",
            "library_ms": None}


def tp_k2_block_row(out, problems, launches):
    """K2's pre-pass block route (a stochastic engine operand that ranks
    split: e5m2 SR bits at each element's global index) through an
    identity, where each output is one exact product (as
    k2_identity_casts), on the bit pipeline and the hw route: bit for bit
    against its plain version and against the block of the whole
    operand's K2 call.  A seq half of one (256, 64) attention slice of the
    large preset and a column quarter of the (2048, 2304) gate output; the
    column block on the bit pipeline timed.  Returns its kernels row."""
    import torch
    from fp8tpu_torch.kernels import qmatmul
    from fp8tpu_torch.numerics.formats import RoundMode
    from fp8tpu_torch.parallel.data import Block
    from fp8tpu_torch.tools import device_ms
    gen = torch.Generator(device="cuda").manual_seed(27)
    sr, rne = RoundMode.STOCHASTIC, RoundMode.RNE
    cases = (("seq", (128, 64), Block((256, 64), (128, 0))),
             ("column", (2048, 576), Block((2048, 2304), (0, 1152))))
    rows, timed, checks = {}, None, 0
    for name, shape, blk in cases:
        whole = torch.randn(blk.shape, device="cuda", generator=gen) * 3.0
        r0, c0 = blk.start
        x = whole[r0:r0 + shape[0], c0:c0 + shape[1]].contiguous()
        sx = 57344.0 / whole.abs().max()
        eye = torch.eye(shape[1], device="cuda")
        for impl in ("bitexact", "hw"):
            def call(t=x, e=eye, b=blk):
                return qmatmul.qdq_matmul(t, e, "e5m2", sr, None, rne, sx,
                                          seed=TP_SR_SALT, impl=impl,
                                          block_x=b)
            b0 = qmatmul.k2_launches["prepass_block"]
            got = call()
            routed = qmatmul.k2_launches["prepass_block"] - b0
            checks += routed
            want = qmatmul.plain(x, eye, "e5m2", sr, None, rne, sx,
                                 seed=TP_SR_SALT, impl=impl,
                                 block_x=blk) + 0.0
            full = qmatmul.qdq_matmul(
                whole, torch.eye(blk.shape[1], device="cuda"), "e5m2", sr,
                None, rne, sx, seed=TP_SR_SALT, impl=impl)[
                r0:r0 + shape[0], c0:c0 + shape[1]]
            row = {"shape": shape, "global": blk.shape, "start": blk.start,
                   "plain_differ": bits_equal(got + 0.0, want),
                   "whole_differ": bits_equal(got + 0.0, full + 0.0),
                   "block_prepasses": routed}
            if row["plain_differ"] or row["whole_differ"] or routed != 1:
                problems.append(f"K2's pre-pass block route ({name}, "
                                f"{impl}): {row}")
            rows[f"{name}/{impl}"] = row
            if name == "column" and impl == "bitexact":
                # x and I read once, the product written once; one bf16
                # MMA product a term (x's grid values and I are exact in
                # bf16)
                m, k = shape
                t_bytes = 4.0 * (2 * m * k + k * k) / HBM_BYTES_PER_S * 1e3
                t_ops = 2.0 * m * k * k / BF16_TC_FLOPS * 1e3
                timed = {"ms": device_ms(call),
                         "plain_ms": cuda_ms(lambda: qmatmul.plain(
                             x, eye, "e5m2", sr, None, rne, sx,
                             seed=TP_SR_SALT, block_x=blk), iters=3,
                             warmup=1),
                         "bound_ms": max(t_bytes, t_ops),
                         "bound_by": ("operations" if t_ops > t_bytes
                                      else "bytes")}
        del whole, x, eye
    print(f"tp (d): K2's pre-pass block route through an identity: "
          + "; ".join(f"{k} {v['shape']} of {v['global']} at {v['start']}: "
                      f"{v['plain_differ']} elements differ from plain, "
                      f"{v['whole_differ']} from the whole operand's call"
                      for k, v in rows.items())
          + f" (0 required); the column block: kernel {timed['ms']:.5f} ms "
          f"(pre-pass and GEMM), plain {timed['plain_ms']:.4f} ms, bound "
          f"{timed['bound_ms']:.5f} ms ({timed['bound_by']})")
    out["k2_block"] = {"cases": rows, "time": timed}
    return {"name": "qdq_matmul block pre-pass (K2's pre-pass block route: "
                    "e5m2 SR of a column quarter of the (2048, 2304) gate "
                    "output through a (576, 576) identity, each element's "
                    "bits at its global index; off the one-card main path, "
                    "where a world of one holds every operand whole: "
                    "check_launches are this check's)",
            "route": "cuda", "source": "fp8tpu_torch/kernels/csrc/qmatmul.cu",
            "replaces": "fp8tpu/kernels/qmatmul.py:193",
            "launches": launches["qdq_matmul_prepass_block"],
            "check_launches": checks, "max_abs_err": 0.0,
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": None}


def tp_p3_split_row(out, problems, launches):
    """P3's split-block route on the column shards (model TP_P3_SPLIT) of
    the (768, 2304) gate kernel, each in the layout the optimizer keeps (a
    (576, 768) torch leaf read as its Flax (768, 576) view): every shard's
    partial block absmax, their MAX (the all-reduce), then each shard's
    quantization by the whole leaf's block scales and update, against
    one-pass P3 on the whole leaf (parameters, the shard's codes, every
    block's scales) and against the route's plain version, bit for bit.
    One shard's two passes timed.  Returns its kernels row."""
    import torch
    from fp8tpu_torch.kernels import adam8
    from fp8tpu_torch.parallel.data import Block
    from fp8tpu_torch.tools import device_ms
    gen = torch.Generator(device="cuda").manual_seed(26)
    K, N = TP_P3_LEAF
    w = N // TP_P3_SPLIT
    nb = -(-K * N // 256)

    def args_of(count):
        return adam8.Adam8Args(0.9, 0.999, 1e-8,
                               *adam8.bias_corrections(0.9, 0.999, count),
                               weight_decay=1e-4, neg_lr=-1e-3)

    p = torch.randn(K, N, device="cuda", generator=gen) * 0.02
    st = [torch.zeros(nb, 256, dtype=torch.int8, device="cuda"),
          torch.zeros(nb, device="cuda"),
          torch.zeros(nb, 256, dtype=torch.float8_e4m3fn, device="cuda"),
          torch.zeros(nb, device="cuda")]
    g1 = torch.randn(K, N, device="cuda", generator=gen) * 1e-2
    adam8.adam8_update(p, g1, *st, args_of(1), "apply_decay")
    g2 = torch.randn(K, N, device="cuda", generator=gen) * 1e-2
    args = args_of(2)
    ref_p, ref = p.clone(), [t.clone() for t in st]
    adam8.adam8_update(ref_p, g2, *ref, args, "apply_decay")

    def shards(device):
        out_ = []
        for r in range(TP_P3_SPLIT):
            blk = Block((K, N), (0, r * w))
            idx = blk.index((K, w), "cuda")
            pt = p[:, r * w:(r + 1) * w].t().contiguous().to(device)
            gt = g2[:, r * w:(r + 1) * w].t().contiguous().to(device)
            out_.append((adam8.SplitLeaf(
                pt.t(), gt.t(), st[0].reshape(-1)[idx].to(device),
                st[1].clone().to(device), st[2].reshape(-1)[idx].to(device),
                st[3].clone().to(device), 0, r * w, N, "apply_decay"), idx))
        return out_

    def split_step(leaves, amax_fn, apply_fn, device):
        amax = torch.zeros((2, nb), dtype=torch.int32, device=device)
        for lf, _ in leaves:
            part = torch.zeros_like(amax)
            amax_fn(lf, args, part)
            amax = torch.maximum(amax, part)
        for lf, _ in leaves:
            apply_fn(lf, args, amax)

    s0 = adam8.split_launches
    kern = shards("cuda")
    split_step(kern, adam8.adam8_split_amax, adam8.adam8_split_apply, "cuda")
    split_n = adam8.split_launches - s0
    plain = shards("cpu")
    split_step(plain, adam8.adam8_split_amax_plain,
               adam8.adam8_split_apply_plain, "cpu")
    bad_one = bad_plain = 0
    for r, ((lk, idx), (lp, _)) in enumerate(zip(kern, plain)):
        got = [lk.p, lk.mq, lk.ms, lk.vq, lk.vs]
        bad_one += sum(bytes_differ(a, b) for a, b in zip(got, [
            ref_p[:, r * w:(r + 1) * w], ref[0].reshape(-1)[idx], ref[1],
            ref[2].reshape(-1)[idx], ref[3]]))
        bad_plain += sum(bytes_differ(a, b) for a, b in zip(
            got, [lp.p, lp.mq, lp.ms, lp.vq, lp.vs]))
    lk = kern[0][0]
    amax = torch.zeros((2, nb), dtype=torch.int32, device="cuda")

    def route():
        amax.zero_()
        adam8.adam8_split_amax(lk, args, amax)
        adam8.adam8_split_apply(lk, args, amax)

    def plain_route():
        amax.zero_()
        adam8.adam8_split_amax_plain(lk, args, amax)
        adam8.adam8_split_apply_plain(lk, args, amax)

    n = K * w
    timed = {"ms": device_ms(route, iters=4, replays=3),
             "plain_ms": cuda_ms(plain_route, iters=2, warmup=1),
             # p, g, the codes and every block's scales and absmax slots,
             # each read once; p, the codes and the scales written once
             "bound_ms": (16.0 * n + 24.0 * nb) / HBM_BYTES_PER_S * 1e3}
    print(f"tp (d): P3's split-block route, {TP_P3_SPLIT} column shards of "
          f"the {TP_P3_LEAF} gate kernel ({split_n} launches): against "
          f"one-pass P3 on the whole leaf {bad_one} differing bytes, "
          f"against its plain version {bad_plain} (0 required); one shard "
          f"({n} elements, {nb} blocks): kernel {timed['ms']:.5f} ms for "
          f"both passes, plain {timed['plain_ms']:.4f} ms, bytes bound "
          f"{timed['bound_ms']:.5f} ms")
    if bad_one or bad_plain or split_n != 2 * TP_P3_SPLIT:
        problems.append(f"P3's split-block route: {bad_one} / {bad_plain} "
                        f"bytes, {split_n} launches")
    out["p3_split"] = {"bytes_differ_one_pass": bad_one,
                       "bytes_differ_plain": bad_plain, "time": timed}
    return {"name": "adam8_split (P3's split-block route: a column quarter "
                    "of the (768, 2304) gate kernel, partial block absmax "
                    "then the update by the whole leaf's scales, both "
                    "passes; off the one-card main path, where a world of "
                    "one holds every leaf whole: check_launches are this "
                    "check's)",
            "route": "cuda", "source": "fp8tpu_torch/kernels/csrc/adam8.cu",
            "replaces": "fp8tpu/training/opt8.py:104 (XLA ops, no TPU "
                        "kernel)",
            "launches": launches["adam8_split"], "check_launches": split_n,
            "max_abs_err": 0.0,
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": "bytes",
            "library_ms": None}


def phase_tp(record):
    """Tensor parallelism inside the decoder over NCCL in a world of one:
    7a's PTQ forward (K1), 7b's engines (K3, K4, K6), K3 and K4 at the
    shard shapes, 7c's model-parallel training step (K1, P3; K2 with hw
    patching) and the block routes of K1 and P3.  Returns the kernels
    record's rows."""
    import torch.distributed as dist
    from fp8tpu_torch.parallel import init_world, make_mesh
    init_world("cuda")
    out, problems = {}, []
    try:
        mesh = make_mesh(data=1, model=1)
        rows = [tp_ptq(out, problems, mesh)]
        launches, _, params = tp_serve(out, problems, mesh)
        k6, k6_err = tp_k6_row(launches, tp_config().n_kv_heads)
        if k6_err:
            problems.append("K6 at the TP ring differs from plain")
        rows += tp_shapes(out, problems, launches, params) + [k6]
        del params
        mesh = make_mesh(data=1, seq=1, model=1)
        train = tp_train(out, problems, mesh)
        rows += [tp_k1_block_row(out, problems, train),
                 tp_k2_block_row(out, problems, train),
                 tp_p3_split_row(out, problems, train)]
    finally:
        dist.destroy_process_group()
    record["tp"] = out
    if problems:
        raise PhaseError("; ".join(problems))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="build,k1,k2,k3,k4,k5,k6,t1,t2,p3,main,train,"
                            "train_lm,serve,serve_paged,spec,moe,flush,time,"
                            "w8a8,deploy,sparse,vision,bert,examples,"
                            "parallel,tp")
    ap.add_argument("--out", default="chip_smoke_out/chip_smoke.json")
    ap.add_argument("--package-tree", default=None,
                    help="import fp8tpu_torch from this tree (a git archive "
                         "of another commit) rather than from beside the "
                         "script: timing phases then measure that commit's "
                         "kernels with this script, for turns in one call")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.package_tree) if args.package_tree
                    else os.path.dirname(os.path.abspath(__file__)))
    try:
        import fp8tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the fp8tpu_torch package is missing: {e}",
              file=sys.stderr)
        return 2

    from fp8tpu_torch.tools import card_line
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; fp8tpu_torch from "
          f"{os.path.dirname(os.path.dirname(fp8tpu_torch.__file__))}")
    record = {"card": card, "phases": {}}
    launches = serve_launches = paged_launches = train_launches = None
    lm_launches = None
    kernels, study_kernels, spec_kernels, moe_kernels = [], [], [], []
    p3_kernels, model_kernels = [], []
    ok = True
    for phase in phases:
        t0 = time.perf_counter()
        try:
            if phase == "build":
                phase_build(record)
            elif phase == "k1":
                phase_k1(record)
            elif phase == "k2":
                phase_k2(record)
            elif phase == "k2_probe":
                phase_k2_probe(record)
            elif phase == "w8a8_probe":
                phase_w8a8_probe(record)
            elif phase == "w8a8k":
                w8a8_kernel_checks(record)
            elif phase == "w8a8_time":
                time_w8a8_kernels(record)
            elif phase == "w8a8_steps":
                steps = {"decode": time_direct_step(),
                         "prefill": time_direct_prefill()}
                record.setdefault("time", {})["w8a8_steps"] = steps
                if codes_route():
                    two_launches(steps)
            elif phase == "w8a8_p1probe":
                phase_w8a8_p1probe(record)
            elif phase == "profile_probe":
                phase_profile_probe(record)
            elif phase == "k4_layers":
                phase_k4_layers(record)
            elif phase == "k3":
                phase_k3(record)
            elif phase == "k4":
                phase_k4(record)
            elif phase == "k5":
                phase_k5(record)
            elif phase == "k6":
                phase_k6(record)
            elif phase == "t1":
                study_kernels += phase_t1(record)
            elif phase == "t2":
                study_kernels += phase_t2(record)
            elif phase == "main":
                launches = phase_main(record, BATCH)
            elif phase == "train":
                train_launches = phase_train(record, BATCH)
            elif phase == "p3":
                p3_kernels = phase_p3(record)
            elif phase == "train_lm":
                lm_launches = phase_train_lm(record)
            elif phase == "train_lm_control":
                phase_train_lm_control(record)
            elif phase == "serve":
                serve_launches = phase_serve(record)
            elif phase == "serve_paged":
                paged_launches = phase_serve_paged(record)
            elif phase == "spec":
                spec_kernels = time_spec(record, phase_spec(record))
            elif phase == "moe":
                moe_kernels += time_moe(record, phase_moe(record))
            elif phase == "flush":
                moe_kernels += phase_flush(record)
            elif phase == "w8a8":
                moe_kernels += time_w8a8(record, phase_w8a8(record))
            elif phase == "deploy":
                phase_deploy(record)
            elif phase == "sparse":
                phase_sparse(record)
            elif phase == "vision":
                model_kernels += phase_vision(record)
            elif phase == "bert":
                model_kernels += phase_bert(record)
            elif phase == "examples":
                phase_examples(record)
            elif phase == "parallel":
                model_kernels += phase_parallel(record)
            elif phase == "tp":
                model_kernels += phase_tp(record)
            elif phase == "time":
                if None in (launches, serve_launches, paged_launches,
                            train_launches):
                    raise PhaseError("the time phase needs the main, train, "
                                     "serve and serve_paged phases")
                kernels = phase_time(record, BATCH, launches)
                kernels += phase_time_train(record, train_launches)
                kernels += phase_time_serve(record, serve_launches)
                kernels[5:5] = phase_time_paged(record, paged_launches)
            else:
                raise PhaseError(f"unknown phase {phase!r}")
            status = "ok"
        except Exception as e:  # report every phase, then fail the run
            import traceback
            traceback.print_exc()
            status = f"FAIL: {type(e).__name__}: {e}"
            ok = False
        seconds = time.perf_counter() - t0
        record["phases"][phase] = {"status": status, "seconds": seconds}
        print(f"phase {phase}: {status} ({seconds:.1f} s)", flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1, default=str)
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    for row in p3_kernels:     # launches on the decoder's training path
        row["launches"] = (lm_launches or {}).get("adam8_update", 0)
    if kernels or study_kernels or spec_kernels or moe_kernels or p3_kernels \
            or model_kernels:
        print(json.dumps({"kernels": kernels + study_kernels
                          + spec_kernels + moe_kernels + p3_kernels
                          + model_kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
