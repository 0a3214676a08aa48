#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port (``src/repro_torch``).

Drives the port's main paths once on one NVIDIA GPU and holds every
hand-written kernel on it against its plain PyTorch version:

1. environment: the card's name and power limit, torch and CUDA versions,
   TF32 switched off for matmuls and convolutions, the host's memory
   (``MemTotal``, ``MemAvailable``) and CPUs; then a pinned host tensor of
   the ``dlrm-ctr`` master's size (29.19 GB): the seconds pinning took, and
   one step's buffer (K = 319,488 rows x 128 f32, 163.6 MB) copied each
   way from it, timed by CUDA events (``pin_probe``);
2. build: compiles every kernel from ``src/repro_torch/csrc`` with nvcc, one
   process per source, all at once; each source's nvcc seconds, ptxas's
   registers and spills (the ``hstu_attention`` forward's, the tf32x3
   ``flash_attention`` forward's and the tf32x3 backward's dq and dk/dv
   kernels' by head dim, each general ``flash_attention`` backward
   kernel's, and the wgmma forward's and the wgmma backward's dq and
   dk/dv kernels' by head dim), the HGMMA instructions in the wgmma
   ``flash_attention`` library (by head dim too) and in the wgmma
   backward's dq and dk/dv kernels apart, and the HMMA
   (``mma.sync``) instructions of the tf32x3 ``flash_attention`` library,
   of the tf32x3 backward's dq and dk/dv kernels apart, and of each
   ``hstu_attention`` kernel, the forward and the two backward kernels
   apart (``cuobjdump -sass``; none may be 0);
3. kernel edges: ``embedding_gather``, ``segment_rowsum``, ``buffer_sync``
   and ``embedding_scatter`` against their plain versions at edge cases
   (empty, one segment, drop ids and sentinels, negative sources, D in
   {1, 33, 128}, a view off 16-byte alignment; for ``embedding_scatter``
   also every slot a sentinel, one valid slot among 1,000 sentinels, valid
   slots only at lanes 0 and 31 of a 32-slot group, n = 31 and 33, at D in
   {1, 33, 128, 512}; for ``segment_rowsum`` also hot keys, one id's run of
   C - 1, C, C + 1 and 5,400 positions at D 512, C = 64 positions a chunk,
   ``segment_rowsum.CHUNK``; for ``embedding_gather`` also few wide rows,
   n in {1, 8, 32, 33} at D 5,120, rows of 5,121 and views off alignment
   at D 5,120 and 5,121, every slot a sentinel at n 32, D 5,120, and 60,000
   narrow rows with sentinels, f32 and bf16), bit for bit where the sums
   are exact (``segment_rowsum`` against the CPU plain version in its chunk
   order, and the input-order one on integer grads or runs of at most C),
   and the same bits on two runs (every gather check, here and on the
   captured main-path calls, runs the kernel twice);
4. a full-width ``dlrm-ctr`` training session (``mode="nestpipe"``,
   ``global_batch=8192``, N = 4, ``bucket_slack=1.5``) on the 29.19 GB
   table: what ``time_ms`` reads for an empty kernel and for one 16-byte
   row gathered by the kernel and by ``index_select`` (``timing_floor``);
   one warm-up step, then two steps whose kernel calls are captured,
   and every captured call checked against its plain version and timed
   beside the plain version, one PyTorch library call where there is one,
   and its bandwidth bound (``segment_rowsum`` also by part: the sort, the
   starts pass, the sum pass and the combine pass; each gather with the
   launch plan it ran, ``embedding_gather.launch_plan``, bound / ms, and
   its and ``index_select``'s times after a flush that leaves the L2
   clean);
5. main path, training: ``train(8)`` with every launch counted; finite
   losses, no routing overflow, the master still full on the card, rows of
   window 0 changed;
6. main path, serving: the trained weights served from the same session,
   4,096 requests in windows of 512, ``check_exact=True``, gather launches
   counted (and the four gathers of one serving window timed first);
6a. full-width ``dlrm-ctr`` training through the host tier (a pinned
   29.19 GB master in host memory), the cached tier (the default 3.65 GB
   device cache, 8-row chunks, ``freq``), the cached tier again with a
   cache of 131,072 rows under ``lru`` (the default one holds every chunk
   a short run touches, so only this one evicts) and the device tier,
   each from seed 0: one warm-up step, then 10 counted; the same losses and the
   same master rows and adagrad state at every key the steps touched, bit
   for bit; the master pinned, the card holding only the dense model, the
   buffers and the cache while the steps run; per tier step p50 and p99,
   samples/s, host ms per stage, bytes each way and the copies' device
   time (so GB/s), peak device memory, and for the cached tier the hit
   rate after the first step, bursts, admissions and evictions (the
   evicting run must evict); launches counted;
6b. the cached path's kernel calls from those runs (the default cache's
   third assembly: the cache's and the staged misses' rows and their D = 1
   adagrad state; its third admission's pulls and cache scatter; its third
   commit's cache scatter and cold pulls; the evicting run's first
   eviction's pulls), checked bit for bit
   against the plain versions and timed beside ``index_select`` or
   ``index_copy_`` and their byte bounds, each gather with its launch plan;
6c. full-width serving through the cached tier: the master trained in 6a,
   4,096 requests in windows of 512, ``head="dlrm"``, the read horizon on,
   ``check_exact=True`` (``exact`` must be 1); qps, p50 and p99, the hit
   rate and the admissions; launches counted; then the same master served
   again with ``sparse_comm="pack"`` (``exact`` 1, the same results, its
   bytes beside ``off``'s);
6d. each cache policy (freq, lfu, lru, oracle) on ``dlrm-cached``,
   ``dlrm-drift`` and ``dlrm-growth`` (their full sizes) with a 1,024-row
   cache, batch 1,024, 6 steps: the host tier's losses and master bit for
   bit, evictions required; hit rates and evictions printed;
6e. the async stage executor at full width, as in 6a (seed 0, one warm-up
   step, 10 counted): the host tier and the cached tier with
   ``async_stages="on"`` and one stage worker, the host tier with
   ``stage_workers=2`` at lookahead 3, and the host tier at lookahead 3
   under a forced race (window 5's retrieve held until commit 3 is
   submitted); each run's losses and the rows and adagrad state of every
   touched key equal 6a's synchronous run of its tier bit for bit; the
   race's hook log shows it happened, and it ran deferred repairs and more
   than ``steps - 1`` ``buffer_sync`` launches; per run step p50 and p99,
   samples/s, host ms per stage (on the worker threads), bytes and GB/s,
   repairs by kind, the pinned host memory the counted steps allocated
   (the caching host allocator's ``cudaHostAlloc`` calls and bytes), each
   beside the synchronous run's (``--profile``: the device idle share over 4 steps of
   each async tier, beside 6a's);
6f. the sparse-comm modes at full width on 6a's evicting cache (131,072
   rows, lru: the one that commits cold rows), sync and async: ``pack``
   equals 6a's run of that cache (``off``) bit for bit, with
   ``wire_bytes``, ``idx_bytes``, ``h2d_bytes`` and ``d2h_bytes`` beside
   off's; ``int8`` prints its largest loss deviation from off, its
   ``comm_rows_synced`` (required above 0) and ``comm_rows_deferred`` and
   bytes, its losses finite; one more synchronous ``int8`` run syncs every
   cold row (``min_sync_p`` = 1, none deferred, required) and prints its
   deviation, which is the quantization's alone;
6g. checkpoints at full width (``checkpoint``): a ``dlrm-ctr`` session as in
   phase 5 (``data_seed=0``, ``ckpt_every=3``) trains 5 steps and saves at
   step 3 through the driver's seam into ``build/ckpt_smoke`` (29.42 GB:
   the checkout's own disk; the phase fails if it cannot hold one
   checkpoint and 5%); its session goes, and one drawn from seed 1
   restores the newest verifiable checkpoint (step 3, every leaf's CRC32
   checked) into its own tensors and trains steps 4-5, counted; the two
   losses, the dense params and AdamW state, the rows and adagrad state at
   every key steps 4-5 touched and at 1,048,576 sampled keys equal the
   first session's bit for bit; the save's seconds (D2H, write and CRC)
   and the restore's (verify, load and H2D) with GB/s, the device's peak
   memory over each (one master), both sessions' step times and p50, and
   no step after the save flagged a straggler; the directory is removed.
   Then ``dlrm-cached`` (its full size) on the cached tier with a 1,024-row
   cache that evicts, batch 1,024, exports at steps 2 and 4 of 5 to the
   driver's checkpoint callback with async stages off and on: the same
   bits (``checkpoint_async_export``);
6h. faults at full width: (``chaos``) 6a's host tier and evicting cache,
   async stages off and on, each as in 6a with
   ``fault_inject="plan:step=1;retrieve:step=2;commit:step=3;h2d:step=1;
   d2h:step=5"`` (every store site once in the counted run): the losses,
   the rows and adagrad state at every touched key and at 1,048,576
   sampled keys, the dense params and AdamW state equal 6a's synchronous
   fault-free run of the tier bit for bit, with ``faults_injected`` 5, ``stage_retries`` at least 3 and
   ``commit_rollbacks`` at least 2; each run's step p50 and p99 beside the
   fault-free run's, the steps the watchdog flagged and its seconds; then
   (``preemption``) the async host tier with a guard on SIGTERM and no
   periodic save: the batch source sends a real SIGTERM as it yields batch
   3 of 5, the driver stops at the next step boundary (``preempted_at``
   from 1 to 4 required) and saves on its way out into
   ``build/ckpt_smoke`` (the phase fails if the disk cannot hold one
   checkpoint and 5%), the guard gives SIGTERM back its handler (required),
   and a session from seed 1 restores the save and trains the steps left:
   the losses, dense params, AdamW state and the rows and adagrad state at
   the touched and sampled keys equal an uninterrupted 5-step run bit for
   bit, and the two runs launch what it launches; the save's and the restore's seconds and GB/s and the device's peak
   memory over each (one master) are printed, and the directory removed;
7. consistency at the reduced ``dlrm-ctr``: nestpipe = serial = the naive
   reference trainer within 1e-5 over 6 steps, and async diverges; the
   reference, run twice from the same state, gives the same bits (its sum
   has a fixed order); the longest run of one key in a micro-batch, beside
   ``segment_rowsum.CHUNK``, and whether nestpipe equals the reference bit
   for bit;
8. HSTU kernel edges: the ``hstu_attention`` forward and backward kernels
   against their plain versions at T in {1, 33, 256, 1024}, (dqk, dv) in
   {(128, 128), (16, 8), (48, 96)}, and T in {65, 1024} at (5, 3), causal
   and not, on strided q, k, v
   (column slices of one (..., 2dqk + 2dv) tensor, as the layer makes
   them), within 1e-5 of each output's sum of magnitudes plus 1e-7, and the
   same bits on two runs;
9. full-width HSTU training: ``hstu-industrial`` at every published width
   (d_model 1024, 4 layers, 8 heads, T = 1024, dim 512, bf16 lookups) with
   each vocabulary divided by 6.25 to fit one card (a 49.48 GB master,
   ``HSTU_INDUSTRIAL_ONE_CARD``), hand-assembled and run through
   ``Session.from_workload`` with ``mode="nestpipe"``, batch 256, N = 4,
   ``bucket_slack=1.5``: one warm-up step, two steps whose kernel calls
   are captured (the first ``hstu_attention`` forward and backward, and
   the embedding kernels' calls as in phase 4), the embedding kernels'
   calls checked and timed as in phase 4, then ``train(6)`` with every
   launch counted; finite losses, no routing overflow, peak memory,
   samples/s, tokens/s, step p50 and p99 (``--profile``: the device idle
   share over 2 more steps); then, with the session released, the captured
   attention calls checked against the plain versions and timed beside
   their bound (operations at the faster of the f32 cores and 3xTF32 on
   the tensor cores; the f32-core time beside it), the forward also in TF32 MMA TFLOP/s and
   its share of the TF32 peak (exactly 32 forward calls a step);
10. consistency at ``hstu-reduced``: nestpipe = serial = the reference
   trainer over 6 steps, and async diverges, at the configuration's own
   step sizes and at the smaller ones of the CPU parity tests; the
   reference gives the same bits twice, and the longest key run is printed
   as in phase 7;
11. release: every earlier session gone (the memory still allocated is
   printed);
11a. ``flash_attention`` backward edges: the backward kernel that
   ``flash_attention.bwd_variant`` picks (``csrc/flash_attention_bwd_tf32.cu``
   for f32 at hd <= 128, ``csrc/flash_attention_bwd_wgmma.cu`` for bf16 at
   hd 64, 80, 128 and 160, ``csrc/flash_attention_bwd.cu`` for the rest)
   and, for every f32 case at hd <= 128 and every bf16 case at hd 64, 80,
   128 and 160, the general one too (``flash_attention_bwd_simple``), each
   checked by its counter, on the forward's output and row logsumexp (the
   tf32x3 kernel's in f32 at hd <= 128, the wgmma kernel's in bf16 at hd
   64, 80, 128 and 160, the general kernel's otherwise; its counter
   checked) and a
   random output gradient, against ``ref.flash_attention_bwd_ref`` within
   ``ref.flash_attention_bwd_bound`` (1e-5 of each gradient's sum of
   magnitudes + 1e-7, plus one bf16 ulp in bf16; for the wgmma kernel its
   ``products="bf16"`` form, 2**-8 of the terms' magnitudes more; the
   general kernel on the same bf16 inputs held to the f32 form) at T in
   {1, 33, 64, 257, 512}, hd in {16, 64, 80, 128, 160}, H/KV in {1, 4},
   causal and full, f32, and bf16 at hd 16, 64, 80, 128 and 160; Tq 33 against
   Tk 100 and the reverse, f32 and bf16, and strided views off 16-byte
   alignment, f32 and bf16; the same values off alignment and with heads
   outside positions give the contiguous layout's bits through the tf32x3
   backward and the wgmma one (its views copied); bf16 values of one sign
   (q and k times 1, 2 and 3) at hd 80 through the wgmma kernel within its
   bound; at hd 160 (1 x 512 x 8 heads over 2; q and k of one sign times
   1, 2 and 3, v and do plus 2) both kernels within their bounds of the
   plain version, their shares of it against the plain version and an f64
   evaluation printed (``flash_bwd_same_sign_bf16``); values of one sign at
   FuXi's shape (v and do plus
   2; q and k times 1, 2 and 3, three draws each) through both backward
   kernels, their shares of the bound against an f64 evaluation and the
   plain version printed (``flash_bwd_same_sign``), the tf32x3 kernel held
   within the bound of the f64 evaluation at every scale where the general
   kernel holds it (the first draw at times 1 through both kernels against
   the plain version too); the forward's lse against
   ``ref.flash_attention_lse_ref`` within ``ref.flash_attention_lse_bound``;
   every check runs each kernel twice for the same bits;
11b. full-size FuXi training: ``fuxi-kuairand`` at every published width
   and its full vocabularies (d_model 512, 4 layers, 8 heads of 64, T 512,
   dim 256, bf16 lookups; a 32.80 GB master), through
   ``Session.from_arch`` with ``mode="nestpipe"``, batch 256, N = 4,
   ``bucket_slack=1.5``, after the HSTU session is gone: one warm-up step,
   two steps whose kernel calls are captured (the first
   ``flash_attention`` forward with its lse and backward, and the
   embedding kernels' calls as in phase 4), the embedding kernels' calls
   checked and timed as in phase 4, then ``train(6)`` with every launch
   counted (exactly 32 tf32x3 forward and 16 tf32x3 backward launches a
   step, none of the general or the wgmma forward nor of the general
   backward); finite losses, no routing
   overflow, peak memory, samples/s, tokens/s, step p50 and p99
   (``--profile``: the device idle share over 2 more steps and the top
   device ops); then, with the session released, the captured attention
   calls checked at full shape against the plain versions (the forward
   and its lse through the tf32x3 kernel and through the general one, the
   backward through the tf32x3 backward and the general one) and timed
   beside them, SDPA (its forward, and ``torch.autograd.grad`` through it
   for the backward), their bound (operations in 3xTF32 on the tensor
   cores, the f32-core time beside it; the two forwards, and the two
   backwards, in turns: general, tf32x3, tf32x3, general; the tf32x3 ones
   also in TF32 MMA TFLOP/s and their share of the TF32 peak);
11c. consistency at ``fuxi-reduced``: nestpipe = serial = the reference
   trainer within 1e-5 over 6 steps at the configuration's own step sizes,
   and async diverges; the reference gives the same bits twice;
12. ``flash_attention`` edges: the three forward kernels against the plain
   version at T in {1, 33, 64, 257, 2048}, hd in {16, 64, 80, 128, 160,
   192, 256}, H/KV in {1, 4}, causal and not, f32 and bf16 (bf16 at the
   wgmma kernel's head dims goes to it, and to the general kernel too at T
   33 and 257; f32 at hd <= 128 to the tf32x3 kernel, and to the general
   kernel too; the rest to the general kernel, each asserted by the
   counters), Tq 33 against Tk 100 (hd 160, and hd 64 in f32), and strided
   views (off 16-byte alignment, and 16-byte aligned; hd 160, and hd 64 in
   f32), within ``ref.flash_attention_bound``
   (f32: 1e-5 of each output's sum of |w v| + 1e-7; bf16: 2**-8 of it plus
   one bf16 ulp); the same bits on two runs; the same values give the same
   bits through ``flash_attention`` in a contiguous layout and in each
   layout a TMA map cannot describe (off 16-byte alignment, a row stride of
   164, heads outside positions), each through the wgmma kernel (its
   counter moves), and in f32 at hd 64 off alignment and with heads
   outside positions through the tf32x3 kernel; values of one sign at
   FuXi's shape (v plus 2; q and k times 1, 2 and 3, three draws each)
   through both f32 kernels, their shares of the bound against an f64
   evaluation and the plain version printed (``flash_same_sign``), held
   within the bound of the f64 evaluation (the tf32x3 kernel at every
   scale, the general one at times 1 and 2; the first draw at times 2 also
   of the plain version); the wgmma kernel's row logsumexp at every case
   of its own (every wgmma head dim and T, causal and not, and the strided
   views) within ``ref.flash_attention_lse_bound`` of
   ``ref.flash_attention_lse_ref``, its output with the lse bit for bit
   the output without, and the general kernel's bf16 lse the same way
   (``flash_attention_simple(lse=True)``) at T 33 and 257; a CUDA tensor
   beside a CPU one raises;
13. full-width ``stablelm-12b`` serving (40 layers, d_model 5,120, 32
   heads over 8 kv heads of 160, bf16; 23.26 GB of weights and a 2.06 GB
   master drawn from a seed): ``serve(batch=8, prompt_len=2048, gen=32)``
   once as warm-up, with the first and the last layer's ``flash_attention``
   calls captured and the gathers of the prefill's lookup and of the first
   decode step's (the f32 master retrieve at D = 5,120, two bf16 assembly
   gathers) checked bit for bit and timed as in phase 6, then once counted
   (40 launches of the wgmma flash kernel, all in the prefill, none of the
   general one; 3 gathers per lookup, 32 lookups) with the same tokens; the
   captured flash calls checked at full shape against the plain version,
   through both kernels, and timed beside the general kernel, the plain
   version, SDPA and their bound; a second prefill whose attention
   runs the plain version agrees on the last-token logits within 5e-2 of
   max |logit| (``--profile``: the device idle share of a prefill and of 8
   decode steps);
13b. full-width ``stablelm-3b`` training (32 layers, d_model 2,560, 32
   heads of 80, d_ff 6,912, vocab 50,304, bf16; 2.80 B params drawn from a
   seed, f32 AdamW moments), after the stablelm-12b session is gone,
   through ``Session.from_arch("stablelm-3b", global_batch=8,
   seq_len=4096, n_micro=4)`` on the device tier in ``nestpipe``: one
   warm-up step, two steps whose first wgmma forward with its lse, first
   wgmma backward and embedding-kernel calls are captured (the latter
   checked and timed as in phase 4), then ``train(4)`` with every launch
   counted (256 wgmma forwards with the lse and 128 wgmma backwards a
   step: 32 layers x 4 micro-batches, each forward again in the
   backward; none of the tf32x3 kernels nor of the general forward or
   backward);
   AdamW at lr 3e-5; finite losses, each below the warm-up step's (the
   third step's rises at this and larger steps: no warm-up), no routing
   overflow,
   peak device memory under 80 GB; step p50 and p99, samples/s, tokens/s
   (``--profile``: the device idle share and the top device ops over 2
   more steps); then, with the session released, the captured calls
   checked at full shape (the forward and its lse through the wgmma
   kernel and the general one, the backward through the wgmma kernel and
   the general one) and timed beside the plain versions, SDPA (forward,
   and ``torch.autograd.grad`` through it) and their bf16 bound at 989
   TFLOP/s, the wgmma forward with and without its lse in turns, the
   backward through the general and the wgmma kernel in turns (general,
   wgmma, wgmma, general);
13c. LM consistency: ``stablelm-3b-reduced`` (f32, hd 16: the tf32x3
   kernels) nestpipe = serial = the reference trainer within 1e-5 over 6
   steps, async diverging, at AdamW eps 1e-6 (the CPU parity tests') and
   at the default eps; a 2-layer bf16 stablelm-3b at hd 80 (the
   wgmma forward and the wgmma backward) trained 3 steps on the card and
   on the CPU from one state: each loss within 3% of the CPU's;
13d. full-width ``olmoe-1b-7b`` serving (16 layers, d_model 2,048, 16
   heads of 128, 64 experts top-8 of d_ff 1,024, vocab 50,304, bf16;
   13.63 GB of weights drawn from a seed) through
   ``Session.from_arch("olmoe-1b-7b").serve(batch=8, prompt_len=2048,
   gen=32)``, as 13: 16 wgmma forwards and 96 gathers a serve, the same
   tokens twice, the prefill's logits within 5e-2 of max |logit| of the
   plain attention's; the capacity's dropped picks by layer (the warm-up
   serve); prefill s, decode tokens/s, peak GB (``--profile``: the prefill
   and 8 decode steps); the prefill's first and last attention calls at
   (8, 2,048, 16, 128) checked and timed as 13's;
13e. ``olmoe-1b-7b`` training at every width and 6 of its 16 layers (2.62 B
   params; the f32 AdamW moments of all 16 would be 55.4 GB) through the
   build path, as 13b's cell (batch 8 x 4,096, N = 4, AdamW at lr 3e-5):
   one warm-up step, two captured steps (the embedding kernels' calls
   checked and timed, each MoE call's dropped picks counted), ``train(4)``
   with every launch counted (48 wgmma forwards with the lse and 24 wgmma
   backwards a step, none of the general or tf32x3 kernels), finite losses
   below the warm-up step's, ``moe_aux`` finite and positive each step,
   peak under 80 GB, step p50/p99, tokens/s (``--profile``: 2 more steps);
13f. the olmoe training checkpoint: the session saves (bf16 params, f32
   moments: 26.6 GB into ``build/ckpt_smoke``) and trains 2 more steps; a
   session from seed 1 restores it and trains 2: the same losses and every
   leaf bit for bit (the run restarted at the save, which at bf16 compute
   is the reference: a restarted run retrieves its first rows afresh);
   save and restore seconds, GB/s, peak device GB; then the captured
   hd-128 calls checked and timed as 13b's;
13g. MoE consistency: ``olmoe-1b-7b-reduced`` nestpipe within 1e-5 of
   the reference over 6 steps, serial within 1e-5 of the reference on its
   own unclustered micro-batches, async diverging, at AdamW eps 1e-6 and
   the default; a 2-layer bf16 olmoe at hd 128 (8 experts top-2) on the
   card and on the CPU from one state, each loss within 3%; one
   full-width MoE layer (2 x 4,096 tokens) forward and backward twice on
   one input with the same bits, and its parts timed (routing and slots,
   dispatch, experts, combine);
13h. full-width ``mamba2-370m`` serving (48 Mamba2 layers, d_model 1,024,
   32 heads of 64, N 128, chunk 256; f32 params, bf16 compute) through
   ``Session.from_arch("mamba2-370m").serve(batch=8, prompt_len=2048,
   gen=32)``: 96 gathers a serve and no other kernel (the mixer has none),
   the warm-up serve's first two lookups' gathers checked bit for bit and
   timed as 13's, the same tokens twice, a prefill of 2,048 tokens and one decode step
   against a prefill of 2,049 (last-token logits within 5e-2 of max
   |logit|: the conv and ssm states carried), layer 0's captured SSD call
   (8 x 2,048, 32 heads of 64, N 128; f32, TF32 off) within 1e-4 of max
   |y| of ``ssd_reference`` in f64 on the card, and its device time beside
   the mixer's and the layer's; prefill s, decode tokens/s, peak GB
   (``--profile``: the prefill and 8 decode steps);
13i. ``mamba2-370m`` trained whole at 13b's cell (batch 8 x 4,096, N = 4,
   AdamW at lr 3e-5): one warm-up step, two captured steps (the embedding
   kernels' calls checked and timed), ``train(4)`` with every launch
   counted, finite losses below the warm-up step's, peak under 80 GB, step
   p50/p99, tokens/s (``--profile``: 2 more steps); then
   ``mamba2-370m-reduced`` nestpipe = serial = the reference within 1e-5
   over 6 steps, async diverging, at AdamW eps 1e-6 and the default, and a
   2-layer mamba2-370m at every width on the card and on the CPU from one
   state, each loss within 3%;
13j. ``jamba-v0.1-52b`` served at every width (d_model 4,096, 32 heads of
   128 over 8, 16 experts top-2 of d_ff 14,336, Mamba N 16 and 128 heads of
   64, bf16) with its first 8 of 32 layers (one period: attention at
   offset 4, MoE at the odd offsets; 13.27 B params) through the build
   path: one wgmma forward at hd 128 and 96 gathers a serve, the warm-up
   serve's first two lookups' gathers (4,096-wide rows) checked bit for
   bit and timed as 13's, the same tokens twice, the prefill within 5e-2 of max |logit| of the plain
   attention's, the prefill-plus-decode check of 13h, the attention call
   checked and timed as 13's;
13k. full-width ``whisper-base`` serving (6 + 6 layers, d_model 512, 8
   heads of 64, 1,500 frames, vocab 51,872; f32 params, bf16 compute)
   through ``Session.from_arch("whisper-base").serve(batch=16,
   prompt_len=416, gen=32)``: 18 wgmma forwards a serve at hd 64 (6
   encoder calls without a mask at T 1,500, 6 causal decoder calls, 6 cross
   calls of the prompt against the frames) and 96 gathers, nothing else;
   the warm-up serve's first two lookups' gathers checked bit for bit and
   timed as 13's, the same tokens twice, the prefill within 5e-2 of max
   |logit| of the plain attention's, a prefill of 416 and one decode step
   against a prefill of 417 (the self and the memory caches carried),
   layer 0's three calls checked through the wgmma and the general kernel
   and timed beside SDPA and the bound; prefill s, decode tokens/s, peak GB
   (``--profile``: the prefill and 8 decode steps);
13l. ``whisper-base`` trained whole at Whisper's batch of 256 segments of
   448 tokens (N = 4: micro-batches of 64, AdamW at lr 3e-5,
   ``bucket_slack`` 1.5): one warm-up step, two captured steps (the
   embedding kernels' calls checked and timed; the first forward and
   backward attention call of each kind kept), ``train(4)`` with every
   launch counted (144 wgmma forwards with the lse and 72 wgmma backwards
   a step, none of the general or tf32x3 kernels), finite losses below the
   warm-up step's, peak under 80 GB, step p50/p99, samples/s, decoder
   tokens/s, ``mean_input_wait_ms`` and the stream's host ms a window
   (the frame draw and the rest, on the prefetch thread) (``--profile``: 2
   more steps); then the kept encoder, decoder and cross calls checked at
   full shape (the forward and its lse, the backward within its bf16
   bound) and timed beside the plain versions, SDPA's forward and
   backward and their bf16 bounds;
13m. encoder-decoder consistency: ``whisper-base-reduced`` nestpipe =
   serial = the reference within 1e-5 over 6 steps, async diverging, at
   AdamW eps 1e-6 and the default; whisper-base at every width with 2 + 2
   layers, all 1,500 frames, bf16 (2 segments of 32 tokens, N = 2) on the
   card and on the CPU from one state, each loss within 3%;
13n. full-width ``pixtral-12b`` serving (40 layers, d_model 5,120, 32
   heads of 160 over 8, d_ff 14,336, vocab 131,072, bf16; a stub vision
   frontend of 256 patches) through ``Session.from_arch("pixtral-12b")
   .serve(batch=8, prompt_len=2048, gen=32)``: the prompts behind the
   patches (a prefill of 2,304 positions, a cache of 2,336), 40 wgmma
   forwards and 96 gathers a serve, nothing else; the warm-up serve's
   first two lookups' gathers checked bit for bit and timed as 13's, the
   same tokens twice, the prefill within 5e-2 of max |logit| of the plain
   attention's, the prefill-plus-decode check of 13h behind the same
   patches, the first and the last layer's calls checked and timed as
   13's; prefill s, decode tokens/s, peak GB (``--profile``: the prefill
   and 8 decode steps);
13o. ``pixtral-12b`` trained at every width and 6 of its 40 layers (2.39 B
   params) at 13b's cell (batch 8 x 4,096 positions: 256 zero patches from
   the stream, then 3,840 text keys; N = 4, lr 3e-5): one warm-up step, two
   captured steps (the embedding kernels' calls checked and timed; the
   first forward and backward attention call kept), ``train(4)`` with
   every launch counted (48 wgmma forwards with the lse and 24 wgmma
   backwards a step, none of the general backward), finite losses below
   the warm-up step's, peak under 80 GB (``--profile``: 2 more steps); the
   kept calls checked and timed as 13b's, the backward through the wgmma
   and the general kernel in turns (wgmma, general, general, wgmma; the
   wgmma one at least 10x faster); then ``pixtral-12b-reduced`` nestpipe
   = serial = the reference within 1e-5, async diverging, at AdamW eps
   1e-6 and the default, and a narrow bf16 VLM at hd 160 (2 layers, 2
   heads over 1, d_model 320, 8 patches) on the card and on the CPU from
   one state, each loss within 3%;
14. a ``{"kernels": [...]}`` line (the tf32x3 and the general
   ``flash_attention`` forward and backward at FuXi's main-path shape,
   the general one also at the LM's; the wgmma forward's and the wgmma
   backward's LM-training calls; the data-path kernels' LM-training step;
   the gather's serve of stablelm-12b, mamba2-370m, jamba, whisper-base
   and pixtral-12b each as its 96 calls, and apart as the prefill's three
   and one decode step's three; the gather's and the scatter's cached-path calls of 6b as
   ``dlrm_cached_train_calls``; launches by path, the host and cached
   tiers' training, every run of 6e and 6f, the cached tier's serving
   with and without ``pack``, 6g's resumed steps, 6h's four chaos runs and
   its preempted and resumed run among them, olmoe's serving, training and
   resumed run, mamba2-370m's serving and training, jamba's serving,
   whisper-base's serving and training, pixtral-12b's serving and
   training; the wgmma forward's and backward's
   olmoe calls at hd 128, the forward's jamba call, whisper's hd-64 calls
   of the serve and of training, encoder, decoder and cross, pixtral's
   hd-160 prefill and training calls, the wgmma backward's pixtral call;
   the general backward, on no main path, at pixtral's and stablelm-3b's
   training calls)
   and, last, the ``{"ok": true, ...}`` line.

Every phase prints one JSON line. Nothing is caught: any failure exits
non-zero. Run from the repo root: ``python3 chip_smoke.py`` (``--profile``
adds a host breakdown and a ``torch.profiler`` pass over 4 training steps
and over the serving path, one over 4 more steps of the host and of the
cached tier (read between a run's first stage after its ingest and its
release), one over 2 HSTU steps, one over 2 FuXi steps, one over an LM
prefill and 8 decode steps, and the same for olmoe, mamba2-370m,
whisper-base and pixtral-12b with 2 of their training steps). The phases
from 11a on print their seconds.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import weakref
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

ARCH = "dlrm-ctr"
TRAIN_BATCH = 8192
N_MICRO = 4
SLACK = 1.5
TRAIN_STEPS = 8
MAX_BATCH = 512
N_REQUESTS = 4096
TIMED_RUNS = 30
CONSISTENCY_STEPS = 6
# the host and cached tiers at full width: counted steps after one warm-up.
# The default cache (padded_rows / 8, 890,813 chunks) holds every chunk a
# short run touches (~38k new a window), so a second cached run, with a
# cache of 16,384 chunks under lru, evicts.
TIER_STEPS = 10
# phase 6e: the async stage executor at full width, each run held to 6a's
# synchronous run of its tier; the forced race holds window RACE_WINDOW's
# retrieve until commit RACE_COMMIT is submitted
ASYNC_RUNS = (("host-async", "host", {"async_stages": "on"}),
              ("cached-async", "cached", {"async_stages": "on"}),
              ("host-async-w2-k3", "host",
               {"async_stages": "on", "stage_workers": 2, "prefetch_ahead": 3}),
              ("host-async-race-k3", "host", {"async_stages": "on", "prefetch_ahead": 3}))
RACE_WINDOW, RACE_COMMIT = 5, 3
# phase 6f: the sparse-comm modes on 6a's evicting cache, sync and async,
# held to 6a's run of that cache (off): pack bit for bit, int8 by its loss
# deviation. The default cache holds every row 11 windows touch, so only
# the evicting one commits cold rows: int8's selective sync runs there.
COMM_CACHE = {"cache_rows": 131_072, "cache_policy": "lru"}
COMM_RUNS = tuple((f"cached-evicting-{mode}" + ("-async" if on else ""), "cached",
                   {**COMM_CACHE, "sparse_comm": mode,
                    **({"async_stages": "on"} if on else {})})
                  for mode in ("pack", "int8") for on in (False, True)) + (
    # int8 with every cold row synced at each commit (min_sync_p = 1): the
    # quantization's share of int8's loss deviation, without deferral's
    ("cached-evicting-int8-sync-all", "cached", {**COMM_CACHE, "sparse_comm": "int8"}),)
INT8_SYNC_ALL = "cached-evicting-int8-sync-all"
# The default cached run comes last: its session, and its 29.19 GB master
# on the card, serve in 6c.
TIER_RUNS = (("host", "host", {}),
             ("cached-evicting", "cached", COMM_CACHE),
             ("device", "device", {}), ("cached", "cached", {}))
# every cache policy against the host tier, on the archs whose full size is
# their reduced one, with a cache small enough to evict
POLICY_ARCHS = ("dlrm-cached", "dlrm-drift", "dlrm-growth")
POLICY_BATCH, POLICY_STEPS, POLICY_CACHE_ROWS = 1024, 6, 1024
# phase 6g: full-width dlrm-ctr saves at step CKPT_AT of CKPT_STEPS, and a
# session from another seed restores it and trains the rest; the checkpoint
# lives beside the kernels' build, on the checkout's own disk (a 9p mount
# with 75 GB free on the card's machine; /dev/shm is RAM)
CKPT_AT, CKPT_STEPS = 3, 5
CKPT_DIR = Path(__file__).resolve().parent / "build" / "ckpt_smoke"
# then the cached tier's mid-run exports, sync against async
EXPORT_EVERY, EXPORT_STEPS = 2, 5
# phase 6h: a fault at every store site, each once (step=N counts the calls
# to its own site; the d2h pull of commit 5 needs 6 commits), on the host
# tier and 6a's evicting cache, async stages off and on, each held to 6a's
# synchronous run of its tier; 6a keeps those runs' rows at SAMPLED_KEYS
# random keys besides the touched ones
CHAOS_SPEC = "plan:step=1;retrieve:step=2;commit:step=3;h2d:step=1;d2h:step=5"
CHAOS_SITES = 5
CHAOS_RUNS = (("host-chaos", "host", {}),
              ("host-async-chaos", "host", {"async_stages": "on"}),
              ("cached-evicting-chaos", "cached", COMM_CACHE),
              ("cached-evicting-async-chaos", "cached", {**COMM_CACHE, "async_stages": "on"}))
# the async chaos runs' fault-free counterparts in 6e and 6f (pack replays
# off bit for bit), whose step p50 they print beside 6a's synchronous one
CHAOS_ASYNC_TWIN = {"host-async-chaos": "host-async",
                    "cached-evicting-async-chaos": "cached-evicting-pack-async"}
SAMPLED_KEYS = 1 << 20
# then a real SIGTERM preempts the async host tier: the batch source sends
# it as it yields batch PREEMPT_SIGNAL_AT of PREEMPT_STEPS
PREEMPT_STEPS, PREEMPT_SIGNAL_AT = 5, 3
HSTU_BATCH = 256  # the per-worker share of the 65,536 recsys batch over 256 workers
HSTU_STEPS = 6
# the hstu_attention forward's calls a step: 4 layers x 4 micro-batches x 2
# (each layer's forward runs again in the backward: per-layer remat)
HSTU_FWD_CALLS_PER_STEP = 32
# HSTU's kernels against their plain versions: within HSTU_RTOL of each
# output's sum of magnitudes (ref.hstu_attention_magnitudes) plus HSTU_ATOL;
# the two add the same terms in different orders.
HSTU_RTOL, HSTU_ATOL = 1e-5, 1e-7
# hstu-reduced consistency runs twice: at the configuration's own step sizes
# and at the rowwise-Adagrad step and AdamW eps of the CPU parity tests,
# where rounding does not grow (tests/test_torch_train.py says why). Both
# hold rows and dense params within 1e-5 and the adagrad accumulator within
# 1e-4 of 1 + accum.
HSTU_SMALL_STEPS = {"sparse_lr": 0.002, "adam_eps": 1e-6}
FUXI_ARCH = "fuxi-kuairand"
FUXI_BATCH = 256  # HSTU's batch: the per-worker share of 65,536 over 256 workers
FUXI_STEPS = 6
# the tf32x3 flash_attention forward's calls a step: 4 layers x 4
# micro-batches x 2 (per-layer remat), and the tf32x3 backward's: 4 x 4
FUXI_FWD_CALLS_PER_STEP = 32
FUXI_BWD_CALLS_PER_STEP = 16
LM_ARCH = "stablelm-12b"
# one card's share of decode_32k (batch 128 over 32,768 positions, an
# 859 GB cache at 204,800 B a token): batch 8, 2,048-token prompts, 32 new
LM_BATCH, LM_PROMPT, LM_GEN = 8, 2048, 32
# the prefill's last-token logits with the kernel and with the plain
# attention: within this share of max |logit| (bf16 activations through 40
# layers; a wrong kernel differs by O(1))
LM_LOGIT_RTOL = 5e-2
# full-width LM training: a worker's share of train_4k's 256 sequences of
# 4,096 tokens over 32 workers, in N_MICRO micro-batches of 2
LM_TRAIN_ARCH = "stablelm-3b"
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 8, 4096, 4
# AdamW's step: from a first loss of 11.34, the third step's reads 22.90
# at the default 3e-4 and 12.72 at 3e-5 (H100 80GB HBM3, `launch.train
# --steps 3`; no warm-up: AdamW's first steps move every weight by about
# lr, all together); at 3e-5 every later step stays below the first
LM_TRAIN_LR = 3e-5
# the wgmma forward's calls a step: 32 layers x 4 micro-batches x 2 (each
# layer's forward runs again in the backward: per-layer remat), and the
# wgmma backward's: 32 x 4
LM_FWD_CALLS_PER_STEP, LM_BWD_CALLS_PER_STEP = 256, 128
# the bf16 LM on the card against the port on the CPU: each step's loss
# within this share of the CPU's (both round to bf16 at every op, in other
# orders and places)
LM_BF16_LOSS_RTOL = 0.03
# olmoe-1b-7b (64 experts top-8, 16 heads of 128, bf16): served whole at the
# LM serving cell's shape; trained at every width and MOE_TRAIN_LAYERS of its
# 16 layers (2.62 B params: f32 AdamW moments for all 16 would be 55.4 GB
# alone) at stablelm-3b's training cell's shape and lr
MOE_ARCH = "olmoe-1b-7b"
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 6, 4
# the wgmma forward's calls a step: 6 layers x 4 micro-batches x 2 (remat),
# and the wgmma backward's: 6 x 4
MOE_FWD_CALLS_PER_STEP, MOE_BWD_CALLS_PER_STEP = 48, 24
# the steps each session trains after the olmoe checkpoint (phase 13f)
MOE_CKPT_STEPS = 2
# mamba2-370m (48 Mamba2 layers, d_model 1,024, 32 heads of 64, N 128,
# chunk 256; f32 params, bf16 compute): served and trained whole, at the LM
# serving cell's and stablelm-3b's training cell's shapes
MAMBA_ARCH = "mamba2-370m"
# layer 0's chunked SSD (f32, TF32 off) against the O(L) recurrence in f64
# on the same inputs: within this share of max |y| (a wrong mask or decay
# is off by O(1))
MAMBA_SSD_RTOL = 1e-4
# jamba-v0.1-52b at every width and its first JAMBA_SERVE_LAYERS layers:
# one period of its pattern (attention at offset 4, MoE at the odd ones)
JAMBA_ARCH = "jamba-v0.1-52b"
JAMBA_SERVE_LAYERS = 8
# whisper-base (6 + 6 layers, d_model 512, 8 heads of 64, 1,500 frames,
# vocab 51,872; f32 params, bf16 compute): served and trained whole. Served
# at batch 16, 416-token prompts and 32 generated (448 positions: Whisper's
# text context); trained at Whisper's own batch of 256 segments of 448
# tokens, N_MICRO micro-batches of 64
WHISPER_ARCH = "whisper-base"
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_GEN = 16, 416, 32
WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ, WHISPER_TRAIN_STEPS = 256, 448, 4
# the wgmma forward's calls a serve: 6 encoder (no mask, T 1,500), 6 causal
# decoder and 6 cross (the prompt against the 1,500 frames); a training
# step's: those 18 x 4 micro-batches x 2 (remat) with the lse, and the
# wgmma backward's 18 x 4
WHISPER_FWD_CALLS_PER_SERVE = 18
WHISPER_FWD_CALLS_PER_STEP, WHISPER_BWD_CALLS_PER_STEP = 144, 72
# pixtral-12b (40 layers, d_model 5,120, 32 heads of 160 over 8, d_ff
# 14,336, vocab 131,072, bf16; a stub vision frontend of 256 patches ahead
# of the text): served whole at the LM serving cell's shape (the prompts
# behind the patches: 2,304 positions); trained at every width and
# PIXTRAL_TRAIN_LAYERS of its 40 layers (2.39 B params: 40 layers' f32
# AdamW moments alone would be 96.8 GB) at stablelm-3b's training cell (256
# patches + 3,840 text keys a sequence)
PIXTRAL_ARCH = "pixtral-12b"
PIXTRAL_TRAIN_LAYERS, PIXTRAL_TRAIN_STEPS = 6, 4
# the wgmma forward's calls a training step: 6 layers x 4 micro-batches x 2
# (remat), with the lse; the wgmma backward's at hd 160: 6 x 4
PIXTRAL_FWD_CALLS_PER_STEP, PIXTRAL_BWD_CALLS_PER_STEP = 48, 24
KERNELS = {  # name -> (source, the Pallas kernel it replaces)
    "embedding_gather": ("src/repro_torch/csrc/embedding_gather.cu",
                         "src/repro/kernels/embedding_gather.py:35"),
    "segment_rowsum": ("src/repro_torch/csrc/segment_rowsum.cu",
                       "src/repro/kernels/segment_rowsum.py:52"),
    "buffer_sync": ("src/repro_torch/csrc/buffer_sync.cu",
                    "src/repro/kernels/buffer_sync.py:32"),
    # no Pallas kernel: the XLA scatter of EmbeddingEngine.writeback
    "embedding_scatter": ("src/repro_torch/csrc/embedding_scatter.cu",
                          "src/repro/core/embedding/engine.py:510"),
    # the TPU kernel is forward only; JAX differentiates the layer's jnp form
    "hstu_attention_fwd": ("src/repro_torch/csrc/hstu_attention.cu",
                           "src/repro/kernels/hstu_attention.py:56"),
    "hstu_attention_bwd": ("src/repro_torch/csrc/hstu_attention.cu",
                           "src/repro/kernels/hstu_attention.py:56"),
    # two kernels of one function: the main path's and the general one
    "flash_attention_wgmma": ("src/repro_torch/csrc/flash_attention_wgmma.cu",
                              "src/repro/kernels/flash_attention.py:70"),
    "flash_attention_simple": ("src/repro_torch/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:70"),
    # f32 at head dims up to 128: FuXi's forward
    "flash_attention_tf32x3": ("src/repro_torch/csrc/flash_attention_tf32.cu",
                               "src/repro/kernels/flash_attention.py:70"),
    # the TPU kernel is forward only; JAX differentiates chunked_attention
    # (src/repro/models/layers.py:160): bf16 at hd 64, 80, 128, 160 (LM
    # training's backward), f32 at head dims up to 128 (FuXi's backward),
    # and the general backward (bf16 at other head dims, f32 above 128)
    "flash_attention_bwd_wgmma": ("src/repro_torch/csrc/flash_attention_bwd_wgmma.cu",
                                  "src/repro/kernels/flash_attention.py:70"),
    "flash_attention_bwd_tf32x3": ("src/repro_torch/csrc/flash_attention_bwd_tf32.cu",
                                   "src/repro/kernels/flash_attention.py:70"),
    "flash_attention_bwd_simple": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                                   "src/repro/kernels/flash_attention.py:70"),
}
# the paths each kernel must run on (launched at least once there); 6e's and
# 6f's runs are paths of their own
TIER_PATHS = {run: "dlrm_" + run.replace("-", "_") + "_train"
              for run, _, _ in ASYNC_RUNS + COMM_RUNS + CHAOS_RUNS}
CACHED_PATHS = tuple(TIER_PATHS[run] for run, store, _ in ASYNC_RUNS + COMM_RUNS + CHAOS_RUNS
                     if store == "cached") + ("dlrm_cached_pack_serve",)
# olmoe's training and its resumed run after phase 13f's restore, and its
# serving (phase 13d)
MOE_TRAIN_PATHS = ("moe_train", "moe_ckpt_resume_train")
MOE_PATHS = ("moe_serve",) + MOE_TRAIN_PATHS
# mamba2-370m's serving and training (13h, 13i), jamba's serving (13j)
MAMBA_PATHS = ("mamba_serve", "mamba_train", "jamba_serve")
# whisper-base's serving and training (13k, 13l)
WHISPER_PATHS = ("whisper_serve", "whisper_train")
# pixtral-12b's serving and training (13n, 13o)
VLM_PATHS = ("vlm_serve", "vlm_train")
# phase 6g's resumed run (steps 4-5 after a restore) is a path of its own,
# and so are 6h's preempted run and its resumption together
RUNS_ON = {
    "embedding_gather": ("dlrm_train", "dlrm_serve", "dlrm_host_train",
                         "dlrm_cached_train", "dlrm_cached_serve", "hstu_train",
                         "fuxi_train", "lm_serve", "lm_train", "dlrm_cached_pack_serve",
                         "dlrm_ckpt_resume_train", "dlrm_preempt_resume_train")
    + tuple(TIER_PATHS.values()) + MOE_PATHS + MAMBA_PATHS + WHISPER_PATHS + VLM_PATHS,
    "segment_rowsum": ("dlrm_train", "dlrm_host_train", "dlrm_cached_train",
                       "hstu_train", "fuxi_train", "lm_train", "dlrm_ckpt_resume_train",
                       "dlrm_preempt_resume_train") + tuple(TIER_PATHS.values())
    + MOE_TRAIN_PATHS + ("mamba_train", "whisper_train", "vlm_train"),
    "buffer_sync": ("dlrm_train", "dlrm_host_train", "dlrm_cached_train", "hstu_train",
                    "fuxi_train", "lm_train", "dlrm_ckpt_resume_train",
                    "dlrm_preempt_resume_train")
    + tuple(TIER_PATHS.values()) + MOE_TRAIN_PATHS
    + ("mamba_train", "whisper_train", "vlm_train"),
    # the host tier writes its master back on the host: no device scatter
    "embedding_scatter": ("dlrm_train", "dlrm_cached_train", "dlrm_cached_serve",
                          "hstu_train", "fuxi_train", "lm_train", "dlrm_ckpt_resume_train")
    + CACHED_PATHS + MOE_TRAIN_PATHS + ("mamba_train", "whisper_train", "vlm_train"),
    "hstu_attention_fwd": ("hstu_train",),
    "hstu_attention_bwd": ("hstu_train",),
    # the LM prefill (no lse) and LM training (with its lse), at hd 160
    # (stablelm-12b, pixtral) and 80 (stablelm-3b), 128 (olmoe; jamba's
    # attention layer) and 64 (whisper: non-causal, cross)
    "flash_attention_wgmma": ("lm_serve", "lm_train") + MOE_PATHS + ("jamba_serve",)
    + WHISPER_PATHS + VLM_PATHS,
    # f32 above hd 128 and bf16 off the wgmma head dims: no main path sends
    # it inputs; phases 11a-13 hold it against the plain version and time it
    "flash_attention_simple": (),
    # FuXi's f32 attention, forward and backward
    "flash_attention_tf32x3": ("fuxi_train",),
    "flash_attention_bwd_tf32x3": ("fuxi_train",),
    # bf16 at hd 64, 80, 128 and 160: LM training's backward (phases 13b,
    # 13e-f, 13l, 13o)
    "flash_attention_bwd_wgmma": ("lm_train",) + MOE_TRAIN_PATHS
    + ("whisper_train", "vlm_train"),
    # bf16 at the other head dims and f32 above 128: no main path sends it
    # inputs; phase 11a holds it against the plain version, 11b, 13b and 13o
    # time it at FuXi's, stablelm-3b's and pixtral's calls
    "flash_attention_bwd_simple": (),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def peak_bytes_per_s(name: str) -> float:
    """Published device-memory bandwidth of the card nvidia-smi names
    (NVIDIA data sheets)."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name:
        if "PCIe" in name:
            return 2.0e12
        if "NVL" in name:
            return 3.9e12
        return 3.35e12  # SXM, "NVIDIA H100 80GB HBM3"
    raise SystemExit(f"chip_smoke: no bandwidth figure for {name!r}")


def peak_flops_fp32(torch, name: str) -> float:
    """The f32 CUDA-core peak: SMs x 128 lanes x 2 operations (an FMA) x
    the maximum SM clock nvidia-smi reports."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 128 * 2 * mhz * 1e6


def tf32_flops(name: str) -> float:
    """Dense TF32 tensor-core peak (NVIDIA data sheets, SXM parts)."""
    if "H100" in name or "H200" in name:
        return 495e12
    raise SystemExit(f"chip_smoke: no TF32 figure for {name!r}")


def f32_work_bound(ops, nbytes, name, bandwidth, peak_fp32) -> dict:
    """The bound of f32 products at f32 accuracy: the larger of the bytes
    over the memory rate and the operations over the card's fastest
    f32-accurate rate, the f32 CUDA cores or 3xTF32 on the tensor cores
    (three TF32 operations an f32 one: 165 TFLOP/s on an H100 against the
    cores' 66.9); the f32-core time beside it."""
    by_ops = min(ops / peak_fp32, ops * 3 / tf32_flops(name)) * 1e3
    by_bytes = nbytes / bandwidth * 1e3
    return {"bound_ms": max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "f32_core_bound_ms": ops / peak_fp32 * 1e3}


def bf16_flops(name: str) -> float:
    """Dense bf16 tensor-core peak (NVIDIA data sheets, SXM parts)."""
    if "H100" in name or "H200" in name:
        return 989e12
    raise SystemExit(f"chip_smoke: no bf16 figure for {name!r}")


def flash_work(q, k, causal):
    """(operations, bytes) of ``flash_attention`` for these inputs: 4 hd per
    unmasked (query, key) pair (the score and the weighted sum); q, k, v
    read once and the output written once."""
    b, tq, h, hd = q.shape
    tk = k.shape[1]
    if causal:  # query i sees keys 0..min(i, Tk - 1)
        pairs_per_head = sum(min(i + 1, tk) for i in range(tq))
    else:
        pairs_per_head = tq * tk
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    return 4 * hd * b * h * pairs_per_head, nbytes


def flash_bwd_work(q, k, causal):
    """(operations, bytes) of the ``flash_attention`` backward for these
    inputs: 10 hd per unmasked (query, key) pair (the score and dP again,
    dV, dQ and dK); q, k, v, the output, its gradient and the lse read
    once, dq, dk and dv written once."""
    ops, _ = flash_work(q, k, causal)
    b, tq, h, _ = q.shape
    nbytes = q.element_size() * (4 * q.numel() + 4 * k.numel()) + 4 * b * h * tq
    return ops // 4 * 10, nbytes


def hstu_work(q, dv, causal):
    """(forward, backward) operations of ``hstu_attention`` for these
    inputs: per unmasked (query, key) pair, 2 dqk + 2 dv forward (the score
    and the weighted sum) and 2 (3 dqk + 2 dv) backward (the score again,
    dA, dV, dQ, dK)."""
    b, t, h, dqk = q.shape
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    return pairs * 2 * (dqk + dv), pairs * 2 * (3 * dqk + 2 * dv)


def hstu_fwd_mma_ops(q, dv, causal):
    """TF32 MMA operations the ``hstu_attention`` forward kernel issues for
    these inputs, its three passes included: each warp (16 query rows of a
    128-row block) runs, per step of 32 keys up to T (causal: up to the
    block's last row, skipping steps wholly after the warp's rows), two
    products of 16 x 32 x kD, kD the head dim padded to 16, 32, 64 or 128."""
    b, t, h, dqk = q.shape
    kd = next(p for p in (16, 32, 64, 128) if p >= max(dqk, dv))
    warp_steps = 0
    for row0 in range(0, t, 16):
        block_steps = -(-(min(t, row0 // 128 * 128 + 128) if causal else t) // 32)
        warp_steps += min(block_steps, (row0 + 15) // 32 + 1) if causal else block_steps
    return b * h * warp_steps * 2 * (2 * 16 * 32 * kd) * 3


def flash_tf32_mma_ops(q, k, causal):
    """TF32 MMA operations the tf32x3 ``flash_attention`` forward issues for
    these inputs, its three passes included: each warp (16 query rows of a
    128-row block, below Tq) runs, per step of 32 keys up to Tk (causal: up
    to the block's last row below Tq, skipping steps wholly after the
    warp's rows), two products of 16 x 32 x kD, kD the head dim padded to
    16, 32, 64 or 128."""
    b, tq, h, hd = q.shape
    tk = k.shape[1]
    kd = next(p for p in (16, 32, 64, 128) if p >= hd)
    warp_steps = 0
    for row0 in range(0, tq, 16):
        q0 = row0 // 128 * 128
        block_steps = -(-(min(tk, tq, q0 + 128) if causal else tk) // 32)
        warp_steps += min(block_steps, (row0 + 15) // 32 + 1) if causal else block_steps
    return b * h * warp_steps * 2 * (2 * 16 * 32 * kd) * 3


def flash_bwd_tf32_mma_ops(q, k, causal):
    """TF32 MMA operations the tf32x3 ``flash_attention`` backward issues for
    these inputs, its three passes included. In the dq kernel each warp (16
    query rows of a 128-row block, below Tq) runs, per step of 32 keys up to
    Tk (causal: up to the block's last row below Tq, skipping steps wholly
    after the warp's rows), three products of 16 x 32 x kD (S, dP, dS K);
    in the dk/dv kernel each warp (16 key rows of a 128-row block, below
    Tk) runs, for each query head of its group, per step of 32 queries from
    the block's first key (causal) or 0 up to Tq, skipping steps wholly
    before the warp's keys, four (S^T, dP^T, P^T dO, dS^T Q). kD is the head
    dim padded to 16, 32, 64 or 128."""
    b, tq, h, hd = q.shape
    tk = k.shape[1]
    kd = next(p for p in (16, 32, 64, 128) if p >= hd)
    dq_steps = sum(1 for row0 in range(0, tq, 16)
                   for k0 in range(0, min(tk, tq, row0 // 128 * 128 + 128) if causal else tk,
                                   32)
                   if not (causal and k0 > row0 + 15))
    kv_steps = sum(1 for key0 in range(0, tk, 16)
                   for i0 in range(key0 // 128 * 128 if causal else 0, tq, 32)
                   if not (causal and i0 + 31 < key0))
    return b * h * (3 * dq_steps + 4 * kv_steps) * (2 * 16 * 32 * kd) * 3


def sass_counts(path, op: str) -> dict:
    """Per kernel of a built library, the SASS instructions whose line holds
    ``op`` (``cuobjdump -sass``); None where cuobjdump fails."""
    out = subprocess.run(["cuobjdump", "-sass", str(path)], capture_output=True, text=True)
    if out.returncode != 0:
        return None
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and op in line:
            counts[fn] += 1
    return counts


def ptxas_by_kernel(report: str) -> dict:
    """Per kernel of a ptxas -v report: registers and spilled bytes."""
    out, fn = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            out[fn].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
    return out


def longest_key_run(batches) -> int:
    """The most positions one key takes in one micro-batch of ``batches``
    (each ``keys`` stacked (N, ...))."""
    import torch

    return max(int(torch.unique(b["keys"][i].reshape(-1), return_counts=True)[1].max())
               for b in batches for i in range(b["keys"].shape[0]))


def same_bits(a, b) -> bool:
    """Two train states with the same bits in table, accumulator and dense
    params."""
    import torch

    return (torch.equal(a.table.rows, b.table.rows) and torch.equal(a.table.accum, b.table.accum)
            and all(torch.equal(a.dense[k], b.dense[k]) for k in a.dense))


def time_ms(torch, fn, flush, clean=False) -> float:
    """Median device time of ``fn`` over TIMED_RUNS launches, each timed
    alone with CUDA events after a write of ``flush`` evicts the 50 MB L2
    (the main path finds the master table cold). The write leaves the L2
    full of dirty lines, so ``fn``'s first ~50 MB of traffic also writes
    them back, as it would after a kernel that wrote as much; ``clean``
    evicts them by a read of ``flush`` instead. A ~100 us spin after the
    flush keeps the card busy until ``fn`` is queued, so the events time
    the device work and not the host's launch overhead."""
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(TIMED_RUNS):
        if clean:
            flush.sum()
        else:
            flush.zero_()
        torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def gather_bytes(torch, src, idx) -> int:
    """Bytes the gather must move for this data: each distinct valid row
    read once, every output row written once, every index read once."""
    valid = idx[(idx >= 0) & (idx < src.shape[0])]
    distinct = int(torch.unique(valid).numel())
    row = src.shape[1] * src.element_size()
    return distinct * row + idx.numel() * row + idx.numel() * idx.element_size()


def segment_bytes(grads, ids, segments) -> int:
    """Each in-range grads row read once, every id read once, every output
    row written once."""
    n_in = int(((ids >= 0) & (ids < segments)).sum())
    row = grads.shape[1] * 4
    return n_in * row + ids.numel() * 4 + segments * row


def sync_bytes(active, prefetch, src) -> int:
    """Per prefetch slot: one row and accumulator read (active or
    prefetch), one row and accumulator written, one index read."""
    kp, d = prefetch.shape
    return kp * (2 * (d * 4 + 4) + 4)


def scatter_bytes(table, idx) -> int:
    """Each valid slot's row and accumulator read and written once, every
    index read once."""
    n_valid = int(((idx >= 0) & (idx < table.shape[0])).sum())
    return n_valid * 2 * (table.shape[1] * 4 + 4) + idx.numel() * 4


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--profile", action="store_true",
                   help="add a host breakdown and a torch.profiler pass over "
                        "training and serving")
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.api import InferenceStrategy, Session, resolve_stream
    from repro_torch.api import session as session_mod
    from repro_torch.api import streams as streams_mod
    from repro_torch.configs import ArchSpec, NestPipeConfig, OptimizerConfig, get_arch
    from repro_torch.configs.recsys_archs import HSTU_INDUSTRIAL_ONE_CARD, HSTU_ROW_CUT
    from repro_torch.core.consistency import build_reference_step
    from repro_torch.core.embedding.engine import LookupPlan
    from repro_torch.core.embedding.routing import SENTINEL, sorted_lookup
    from repro_torch.core.store import CACHE_POLICIES, CachedStore, HostStore, SparseComm
    from repro_torch.data.pipeline import make_cluster_transform, stage_to_device
    from repro_torch.dist.checkpoint import flatten_state
    from repro_torch.kernels import build, dispatch, ref
    from repro_torch.kernels import buffer_sync as bs
    from repro_torch.kernels import embedding_gather as eg
    from repro_torch.kernels import embedding_scatter as es
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import hstu_attention as ha
    from repro_torch.kernels import segment_rowsum as sr
    from repro_torch.launch.build import assemble_workload, make_loss_fn, resolve
    from repro_torch.models import layers as mlayers
    from repro_torch.models import mamba as mmamba
    from repro_torch.models import transformer as mtransformer
    from repro_torch.models.dlrm import make_dlrm_loss_fn
    from repro_torch.serve import synthetic_requests
    from repro_torch.train import clone_state, constant_lr

    dev = torch.device("cuda")
    mods = {"embedding_gather": eg, "segment_rowsum": sr, "buffer_sync": bs,
            "embedding_scatter": es}

    def reset_counts():
        for m in mods.values():
            m.launches = 0
        ha.launches_fwd = ha.launches_bwd = 0
        fa.launches = fa.launches_wgmma = fa.launches_simple = fa.launches_bwd = 0
        fa.launches_tf32x3 = fa.launches_bwd_tf32x3 = fa.launches_bwd_simple = 0
        fa.launches_bwd_wgmma = 0

    def counts():
        return {**{k: m.launches for k, m in mods.items()},
                "hstu_attention_fwd": ha.launches_fwd,
                "hstu_attention_bwd": ha.launches_bwd,
                "flash_attention_wgmma": fa.launches_wgmma,
                "flash_attention_simple": fa.launches_simple,
                "flash_attention_tf32x3": fa.launches_tf32x3,
                "flash_attention_bwd_wgmma": fa.launches_bwd_wgmma,
                "flash_attention_bwd_tf32x3": fa.launches_bwd_tf32x3,
                "flash_attention_bwd_simple": fa.launches_bwd_simple}

    # -- 1. environment ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    peak = peak_bytes_per_s(name)
    meminfo = {ln.split(":")[0]: int(ln.split()[1]) * 1024
               for ln in Path("/proc/meminfo").read_text().splitlines()
               if ln.split(":")[0] in ("MemTotal", "MemAvailable")}
    emit("env", nvidia_smi=smi[0], device=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         peak_bytes_per_s=peak, host_mem_total_gb=meminfo["MemTotal"] / 1e9,
         host_mem_available_gb=meminfo["MemAvailable"] / 1e9,
         cpu_count=os.cpu_count(), cpus_usable=len(os.sched_getaffinity(0)),
         checkpoint_dir=str(CKPT_DIR),
         checkpoint_disk_free_bytes=shutil.disk_usage(Path(__file__).resolve().parent).free)

    # the host tier's master, pinned: how long pinning a tensor of its size
    # takes, and one step's buffer (K rows x 128 f32) copied each way
    tier_wl = resolve(ARCH, device=dev, npcfg=NestPipeConfig(
        fwp_microbatches=N_MICRO, bucket_slack=SLACK), global_batch=TRAIN_BATCH)
    tier_k = tier_wl.engine.dims(tier_wl.batch_shapes["keys"][0][1:], N_MICRO).buffer_cap
    t0 = time.perf_counter()
    probe = torch.empty((tier_wl.spec.padded_rows, tier_wl.spec.dim), pin_memory=True)
    pin_s = time.perf_counter() - t0
    on_card = torch.empty((tier_k, tier_wl.spec.dim), device=dev)
    copy_ms = {}
    for way, (dst, src) in (("h2d", (on_card, probe[:tier_k])),
                            ("d2h", (probe[:tier_k], on_card))):
        times = []
        for _ in range(5):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        copy_ms[way] = statistics.median(times)
    del dst, src  # the probe's views: its pinned block goes back to the cache
    buf_bytes = on_card.numel() * 4
    emit("pin_probe", master_gb=probe.numel() * 4 / 1e9, pin_s=pin_s,
         pinned=probe.is_pinned(),
         host_pinned_allocated_gb=torch.cuda.host_memory_stats().get(
             "allocated_bytes.current", 0) / 1e9,
         buffer_rows=tier_k, buffer_mb=buf_bytes / 1e6,
         h2d_ms=copy_ms["h2d"], d2h_ms=copy_ms["d2h"],
         h2d_gb_per_s=buf_bytes / copy_ms["h2d"] / 1e6,
         d2h_gb_per_s=buf_bytes / copy_ms["d2h"] / 1e6)
    if not probe.is_pinned():
        raise SystemExit("the pinned probe tensor is not pinned")
    tier_dim = tier_wl.spec.dim
    del probe, on_card, tier_wl

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t0
    sass = subprocess.run(["cuobjdump", "-sass", str(build.library_path("flash_attention_wgmma"))],
                          capture_output=True, text=True)
    hgmma = sass.stdout.count("HGMMA") if sass.returncode == 0 else None
    if hgmma == 0:
        raise SystemExit("the wgmma flash_attention library holds no HGMMA instruction")
    # every hstu_attention product: mma.sync m16n8k8 TF32 (HMMA.1688), per
    # kernel (summed over its head-dim instantiations)
    per_fn = sass_counts(build.library_path("hstu_attention"), "HMMA")
    hmma = None if per_fn is None else {
        kn: sum(c for fn, c in per_fn.items() if kn in fn)
        for kn in ("hstu_fwd_kernel", "hstu_bwd_dq_kernel", "hstu_bwd_dkdv_kernel")}
    if hmma is not None and min(hmma.values()) == 0:
        raise SystemExit(f"an hstu_attention kernel holds no HMMA instruction: {hmma}")
    if per_fn is not None and len([fn for fn in per_fn if "hstu_fwd_kernel" in fn]) != 4:
        raise SystemExit(f"the hstu_attention library's kernels: {sorted(per_fn)}")
    # the tf32x3 flash forward: its HMMA, and its registers and spills by
    # padded head dim (kernel<kD>)
    per_fn = sass_counts(build.library_path("flash_attention_tf32"), "HMMA")
    flash_hmma = None if per_fn is None else sum(per_fn.values())
    if flash_hmma == 0:
        raise SystemExit("the tf32x3 flash_attention library holds no HMMA instruction")
    if per_fn is not None and len(per_fn) != 4:
        raise SystemExit(f"the tf32x3 flash_attention library's kernels: {sorted(per_fn)}")
    flash_tf32_ptxas = {"d" + re.search(r"ILi(\d+)E", fn).group(1): v
                        for fn, v in ptxas_by_kernel(build.build_log.get(
                            "flash_attention_tf32", {}).get("ptxas", "")).items()
                        if "flash_tf32_fwd_kernel" in fn}
    # the tf32x3 flash backward: the HMMA of its dq and dk/dv kernels (each
    # summed over its head-dim instantiations), and their registers and
    # spills by padded head dim (kernel<kD>)
    per_fn = sass_counts(build.library_path("flash_attention_bwd_tf32"), "HMMA")
    bwd_tf32_hmma = None if per_fn is None else {
        kn: sum(c for fn, c in per_fn.items() if kn in fn)
        for kn in ("flash_tf32_bwd_dq_kernel", "flash_tf32_bwd_dkdv_kernel")}
    if bwd_tf32_hmma is not None and min(bwd_tf32_hmma.values()) == 0:
        raise SystemExit(f"a tf32x3 flash_attention backward kernel holds no HMMA "
                         f"instruction: {bwd_tf32_hmma}")
    bwd_tf32_ptxas = {}
    for fn, v in ptxas_by_kernel(build.build_log.get("flash_attention_bwd_tf32", {}).get(
            "ptxas", "")).items():
        m = re.search(r"flash_tf32_bwd_(dq|dkdv)_kernelILi(\d+)E", fn)
        if m:
            bwd_tf32_ptxas[f"{m.group(1)}<{m.group(2)}>"] = v
    # the forward's registers and spills by padded head dim (kernel<kD>)
    fwd_ptxas = {"d" + re.search(r"ILi(\d+)E", fn).group(1): v for fn, v in ptxas_by_kernel(
        build.build_log.get("hstu_attention", {}).get("ptxas", "")).items()
        if "hstu_fwd_kernel" in fn}
    # the wgmma flash forward's HGMMA and its registers and spills by head
    # dim (kernel<HD>), the same since its helpers moved into csrc/wgmma.cuh
    per_fn = sass_counts(build.library_path("flash_attention_wgmma"), "HGMMA")
    fwd_wgmma_hgmma = None if per_fn is None else {
        re.search(r"ILi(\d+)E", fn).group(1): c for fn, c in per_fn.items()}
    fwd_wgmma_ptxas = {"hd" + m.group(1): v for fn, v in ptxas_by_kernel(build.build_log.get(
        "flash_attention_wgmma", {}).get("ptxas", "")).items()
        if (m := re.search(r"flash_wgmma_kernelILi(\d+)E", fn))}
    # the wgmma flash backward: the HGMMA of its dq and dk/dv kernels (each
    # summed over its head-dim instantiations; none may be 0), and each
    # kernel's registers and spills by head dim (kernel<HD>)
    per_fn = sass_counts(build.library_path("flash_attention_bwd_wgmma"), "HGMMA")
    bwd_wgmma_hgmma = None if per_fn is None else {
        kn: sum(c for fn, c in per_fn.items() if kn in fn)
        for kn in ("flash_wgmma_bwd_dq_kernel", "flash_wgmma_bwd_dkdv_kernel")}
    if bwd_wgmma_hgmma is not None and min(bwd_wgmma_hgmma.values()) == 0:
        raise SystemExit(f"a wgmma flash_attention backward kernel holds no HGMMA "
                         f"instruction: {bwd_wgmma_hgmma}")
    bwd_wgmma_ptxas = {}
    for fn, v in ptxas_by_kernel(build.build_log.get("flash_attention_bwd_wgmma", {}).get(
            "ptxas", "")).items():
        m = re.search(r"flash_wgmma_bwd_(dq|dkdv|delta)_kernel(?:ILi(\d+)E)?", fn)
        if m:
            bwd_wgmma_ptxas[m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")] = v
    # each flash_attention backward kernel's registers and spills, by type
    # and columns a thread (kernel<T, kC>)
    bwd_ptxas = {re.sub(r".*flash_bwd_(\w+?)_kernel.*?I(f|13__nv_bfloat16)(?:Li(\d+)E)?.*",
                        lambda m: f"{m.group(1)}<{'f32' if m.group(2) == 'f' else 'bf16'}"
                                  + (f",{m.group(3)}>" if m.group(3) else ">"), fn): v
                 for fn, v in ptxas_by_kernel(build.build_log.get(
                     "flash_attention_bwd", {}).get("ptxas", "")).items()}
    emit("build", seconds=round(build_s, 3), sources=list(build.SOURCES),
         nvcc_seconds={k: round(v["seconds"], 3) for k, v in build.build_log.items()},
         flash_wgmma_hgmma_instructions=hgmma, hstu_hmma_instructions=hmma,
         flash_tf32x3_hmma_instructions=flash_hmma, flash_tf32x3_ptxas=flash_tf32_ptxas,
         flash_bwd_tf32x3_hmma_instructions=bwd_tf32_hmma,
         flash_bwd_tf32x3_ptxas=bwd_tf32_ptxas,
         flash_wgmma_hgmma_by_head_dim=fwd_wgmma_hgmma, flash_wgmma_ptxas=fwd_wgmma_ptxas,
         flash_bwd_wgmma_hgmma_instructions=bwd_wgmma_hgmma,
         flash_bwd_wgmma_ptxas=bwd_wgmma_ptxas,
         hstu_fwd_ptxas=fwd_ptxas, flash_bwd_ptxas=bwd_ptxas,
         ptxas={k: [ln.strip() for ln in v["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln]
                for k, v in build.build_log.items()})

    # -- 3. kernels against their plain versions at edge cases ------------
    worst = {k: 0.0 for k in mods}

    def record(kernel, got, want, label, tol=None):
        """Bit for bit, or within ``tol`` (a tensor of per-element bounds)."""
        for a, b in zip(got, want):
            err = float((a - b).abs().max()) if a.numel() else 0.0
            if tol is None and not torch.equal(a, b):
                raise SystemExit(f"{kernel} != plain at {label}: {err}")
            if tol is not None and not bool(((a - b).abs() <= tol).all()):
                raise SystemExit(f"{kernel} beyond its bound at {label}: {err}")
            worst[kernel] = max(worst[kernel], err)

    def check_gather(label, src, idx):
        got = eg.embedding_gather(src, idx)
        if not torch.equal(got, eg.embedding_gather(src, idx)):
            raise SystemExit(f"embedding_gather not deterministic at {label}")
        record("embedding_gather", [got], [ref.gather_rows_ref(src, idx)], label)
        return got

    def check_segment(label, grads, ids, segments, integer):
        got = sr.segment_rowsum(grads, ids, segments)
        again = sr.segment_rowsum(grads, ids, segments)
        if not torch.equal(got, again):
            raise SystemExit(f"segment_rowsum not deterministic at {label}")
        # The card's plain version adds with atomics, in another order: exact
        # on integer grads; otherwise within 1e-6 of each output's sum of
        # magnitudes plus 1e-6 (reordering an f32 sum of n terms moves it by
        # about sqrt(n) * 6e-8 of that sum, (n-1) * 6e-8 at worst).
        tol = None if integer else 1e-6 * ref.segment_rowsum_ref(
            grads.abs(), ids, segments) + 1e-6
        record("segment_rowsum", [got], [ref.segment_rowsum_ref(grads, ids, segments)],
               label, tol)
        if ids.numel() <= 65536:  # on the CPU, bit for bit, in the kernel's chunk order
            cg, ci = grads.cpu(), ids.cpu()
            record("segment_rowsum", [got.cpu()], [ref.segment_rowsum_chunked_ref(
                cg, ci, segments, chunk=sr.CHUNK)], label)
            kept = ci[(ci >= 0) & (ci < segments)].long()
            if integer or kept.numel() == 0 or int(torch.bincount(kept).max()) <= sr.CHUNK:
                # exact sums, or every run one chunk: the input order's bits too
                record("segment_rowsum", [got.cpu()],
                       [ref.segment_rowsum_ref(cg, ci, segments)], label)
        return got

    def check_sync(label, *a):
        got = bs.buffer_sync(*a)
        again = bs.buffer_sync(*a)
        if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
            raise SystemExit(f"buffer_sync not deterministic at {label}")
        record("buffer_sync", got, ref.buffer_sync_ref(*a), label)
        return got

    def check_scatter(label, table, table_accum, idx, rows, accum):
        got, got_acc = table.clone(), table_accum.clone()
        again, again_acc = table.clone(), table_accum.clone()
        want, want_acc = table.clone(), table_accum.clone()
        es.embedding_scatter(got, got_acc, idx, rows, accum)
        es.embedding_scatter(again, again_acc, idx, rows, accum)
        if not (torch.equal(got, again) and torch.equal(got_acc, again_acc)):
            raise SystemExit(f"embedding_scatter not deterministic at {label}")
        ref.embedding_scatter_ref(want, want_acc, idx, rows, accum)
        record("embedding_scatter", [got, got_acc], [want, want_acc], label)

    def misaligned(t):
        flat = torch.cat([t.new_zeros(1), t.reshape(-1)])
        return flat[1:].view(t.shape)  # 4 bytes off 16-byte alignment

    g = torch.Generator(dev).manual_seed(0)

    def randint(lo, hi, n):
        return torch.randint(lo, hi, (n,), device=dev, generator=g, dtype=torch.int32)

    edge = []
    for d in (1, 33, 128):
        t = torch.empty((1000, d), device=dev).normal_(generator=g)
        for n in (0, 1, 777):
            idx = randint(0, 1000, n)
            if n > 1:
                idx[::5] = 1000
                idx[1::7] = SENTINEL
                idx[2::9] = -1
            check_gather(f"D={d} n={n}", t, idx)
            edge.append(f"gather D={d},n={n}")
        check_gather(f"misaligned D={d}", misaligned(t), randint(-2, 1002, 513))
        edge.append(f"gather D={d},misaligned")
        # bf16 rows: the lookups of a model that computes in bf16 (HSTU)
        check_gather(f"bf16 D={d}", t.to(torch.bfloat16), randint(-2, 1002, 777))
        check_gather(f"bf16 misaligned D={d}", misaligned(t.to(torch.bfloat16)),
                     randint(-2, 1002, 513))
        edge.append(f"gather bf16 D={d},aligned and misaligned")
        for n, s in ((0, 7), (300, 1), (2000, 64), (2000, 700)):
            ids = randint(0, s, n)  # unsorted, with repeats
            if n:
                ids[::6] = s
                ids[1::11] = SENTINEL
                ids[2::13] = -1
            for integer in (True, False):
                grads = torch.empty((n, d), device=dev).normal_(generator=g)
                if integer:
                    grads = torch.round(grads * 8)
                check_segment(f"D={d} L={n} S={s}", grads, ids, s, integer)
                check_segment(f"misaligned D={d} L={n} S={s}", misaligned(grads),
                              ids, s, integer)
            edge.append(f"segment_rowsum D={d},L={n},S={s}")
        for ka, kp in ((1, 5), (600, 800), (800, 0)):
            act = torch.empty((ka, d), device=dev).normal_(generator=g)
            pre = torch.empty((kp, d), device=dev).normal_(generator=g)
            aa = torch.rand(ka, device=dev, generator=g)
            pa = torch.rand(kp, device=dev, generator=g)
            src = randint(0, ka, kp)
            if kp:
                src[::3] = ka
                src[1::7] = SENTINEL
                src[2::9] = -1
            check_sync(f"D={d} Ka={ka} Kp={kp}", act, aa, pre, pa, src)
            check_sync(f"misaligned D={d} Ka={ka} Kp={kp}", misaligned(act), aa,
                       misaligned(pre), pa, src)
            edge.append(f"buffer_sync D={d},Ka={ka},Kp={kp}")
        for r, n in ((900, 0), (900, 640)):
            table = torch.empty((r, d), device=dev).normal_(generator=g)
            idx = torch.randperm(r, device=dev, generator=g)[:n].to(torch.int32)
            if n:
                idx[::4] = r
                idx[1::9] = SENTINEL
                idx[2::10] = -1
            rows = torch.empty((n, d), device=dev).normal_(generator=g)
            check_scatter(f"D={d} R={r} n={n}", table, torch.rand(r, device=dev),
                          idx, rows, torch.rand(n, device=dev))
            check_scatter(f"misaligned D={d} R={r} n={n}", misaligned(table),
                          torch.rand(r, device=dev), idx, misaligned(rows),
                          torch.rand(n, device=dev))
            edge.append(f"embedding_scatter D={d},R={r},n={n}")
    # the write-back's sentinel-heavy slots: the kernel takes 32 slots a warp
    # and keeps the valid ones by a ballot
    for d in (1, 33, 128, 512):
        r = 1000
        table = torch.empty((r, d), device=dev).normal_(generator=g)
        one = torch.full((1001,), SENTINEL, dtype=torch.int32, device=dev)
        one[517] = 7
        lanes = torch.full((96,), SENTINEL, dtype=torch.int32, device=dev)
        lanes[0::32] = torch.tensor([3, 500, 999], dtype=torch.int32, device=dev)
        lanes[31::32] = torch.tensor([0, 42, 998], dtype=torch.int32, device=dev)
        cases = [("every slot a sentinel", torch.full((300,), SENTINEL, dtype=torch.int32,
                                                      device=dev)),
                 ("one valid among 1,000 sentinels", one),
                 ("valid only at lanes 0 and 31", lanes)]
        for n in (31, 33):
            idx = torch.randperm(r, device=dev, generator=g)[:n].to(torch.int32)
            idx[::4] = SENTINEL
            idx[1::9] = -1
            cases.append((f"n={n}", idx))
        for label, idx in cases:
            n = idx.numel()
            rows = torch.empty((n, d), device=dev).normal_(generator=g)
            check_scatter(f"{label} D={d}", table, torch.rand(r, device=dev), idx, rows,
                          torch.rand(n, device=dev))
            check_scatter(f"misaligned {label} D={d}", misaligned(table),
                          torch.rand(r, device=dev), idx, misaligned(rows),
                          torch.rand(n, device=dev))
            edge.append(f"embedding_scatter {label}, D={d}")
    # hot keys: one id's run of C - 1, C, C + 1 and 5,400 positions (HSTU's
    # hot row in a micro-batch) among singles and drops, at D = 512
    for run in (sr.CHUNK - 1, sr.CHUNK, sr.CHUNK + 1, 5400):
        ids = randint(0, 4096, run + 4096)
        ids[torch.randperm(ids.numel(), device=dev, generator=g)[:run]] = 3
        ids[::37] = SENTINEL
        for integer in (True, False):
            grads = torch.empty((ids.numel(), 512), device=dev).normal_(generator=g)
            if integer:
                grads = torch.round(grads * 8)
            check_segment(f"hot run {run} D=512", grads, ids, 4096, integer)
            check_segment(f"misaligned hot run {run} D=512", misaligned(grads), ids, 4096,
                          integer)
        edge.append(f"segment_rowsum hot run of {run} at D=512, L={ids.numel()}, S=4096")
    # the gather's few wide rows (a row split over warps and blocks, as the
    # LM decode's 32 x 5,120 f32 and 8 x 5,120 bf16 calls), rows of 5,121
    # (no 16-byte vectors), every slot a sentinel, and many narrow rows
    wide = torch.empty((1000, 5120), device=dev).normal_(generator=g)
    odd = torch.empty((1000, 5121), device=dev).normal_(generator=g)
    for dtype in (torch.float32, torch.bfloat16):
        w, o = wide.to(dtype), odd.to(dtype)
        kind = str(dtype).removeprefix("torch.")
        for n in (1, 8, 32, 33):
            idx = randint(0, 1000, n)
            idx[1::5] = SENTINEL
            check_gather(f"{kind} D=5120 n={n}", w, idx)
            edge.append(f"gather {kind} D=5120,n={n}")
        for n in (1, 32, 777):
            idx = randint(-2, 1002, n)
            check_gather(f"{kind} D=5121 n={n}", o, idx)
            check_gather(f"{kind} misaligned D=5121 n={n}", misaligned(o), idx)
            check_gather(f"{kind} misaligned D=5120 n={n}", misaligned(w), idx)
            edge.append(f"gather {kind} D=5121 and misaligned D=5120/5121,n={n}")
        check_gather(f"{kind} every slot a sentinel", w,
                     torch.full((32,), SENTINEL, dtype=torch.int32, device=dev))
        edge.append(f"gather {kind} D=5120,n=32,every slot a sentinel")
        narrow = wide[:, :128].contiguous().to(dtype)
        idx = randint(-2, 1002, 60_000)
        idx[::13] = SENTINEL
        check_gather(f"{kind} D=128 n=60000", narrow, idx)
        edge.append(f"gather {kind} D=128,n=60000 with sentinels")
    del wide, odd, w, o, narrow
    torch.cuda.synchronize()
    emit("kernel_edges", cases=edge, max_abs_err=worst,
         exact="bit-exact (gathers in f32 and bf16, each the same bits twice), "
               "except segment_rowsum on "
               "normal grads against the card's atomic index_add_: within 1e-6 "
               "of each output's sum of magnitudes + 1e-6 (bit-exact against "
               "the CPU plain version in the kernel's chunk order, and against "
               "the input-order one on integer grads or runs of at most "
               f"{sr.CHUNK})")

    # -- 4. the full-width training session -------------------------------
    sess = Session.from_arch(ARCH, mode="nestpipe", global_batch=TRAIN_BATCH,
                             n_micro=N_MICRO, bucket_slack=SLACK, seed=0)
    wl = sess.workload
    dims = wl.engine.dims(wl.batch_shapes["keys"][0][1:], N_MICRO)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = sess.state
    torch.cuda.synchronize()
    emit("init", seconds=round(time.perf_counter() - t0, 3),
         table_rows=state.table.rows.shape[0], dim=state.table.rows.shape[1],
         table_gb=round(state.table.rows.numel() * 4 / 1e9, 3),
         dims={"L": dims.l_local, "U": dims.u_max, "C": dims.cap,
               "K": dims.buffer_cap, "N": dims.n_micro})

    # one unchecked warm-up step: the counted run below is then not charged
    # with the first calls' CUDA and cuBLAS set-up
    sess.train(1)
    torch.cuda.synchronize()

    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)  # evicts the L2 (time_ms)
    # what time_ms reads for almost no work: an empty kernel, and one
    # 16-byte row gathered by the kernel and by index_select
    tiny, one = torch.zeros((64, 4), device=dev), torch.ones(1, dtype=torch.int32, device=dev)
    one_long = one.long()
    emit("timing_floor", empty_kernel_ms=time_ms(torch, lambda: torch.cuda._sleep(1), flush),
         gather_one_row_ms=time_ms(torch, lambda: eg.embedding_gather(tiny, one), flush),
         index_select_one_row_ms=time_ms(
             torch, lambda: torch.index_select(tiny, 0, one_long), flush))
    del tiny, one, one_long

    def capture_calls(sess):
        """Two training steps with the inputs of the first calls of each
        kind kept: the gathers retrieve 0, retrieve 1 (queued ahead of
        window 0) and window 0's three per micro-batch; the segment sums of
        window 0's micro-batches and its window-to-buffer sum; one
        buffer_sync and one write-back. The master is kept by reference,
        every other tensor copied once (the micro-batches of a window read
        one buffer)."""
        captured = {"gather": [], "segment": [], "sync": [], "scatter": []}
        limits = {"gather": 14, "segment": 5, "sync": 1, "scatter": 1}
        real = {k: getattr(dispatch, k) for k in
                ("gather_rows", "segment_rowsum", "buffer_sync", "scatter_rows")}
        master = sess.state.table
        copies = {}  # id(tensor) -> (weak reference to it, its copy)

        def keep(t):
            if t.data_ptr() in (master.rows.data_ptr(), master.accum.data_ptr()):
                return t
            hit = copies.get(id(t))
            if hit is None or hit[0]() is not t:
                hit = copies[id(t)] = (weakref.ref(t), t.clone())
            return hit[1]

        def capture(kind, fn):
            def run(*a):
                if len(captured[kind]) < limits[kind]:
                    captured[kind].append(tuple(keep(x) if torch.is_tensor(x) else x
                                                for x in a))
                return fn(*a)
            return run

        dispatch.gather_rows = capture("gather", real["gather_rows"])
        dispatch.segment_rowsum = capture("segment", real["segment_rowsum"])
        dispatch.buffer_sync = capture("sync", real["buffer_sync"])
        dispatch.scatter_rows = capture("scatter", real["scatter_rows"])
        try:
            sess.train(2)
        finally:
            for k, fn in real.items():
                setattr(dispatch, k, fn)
        torch.cuda.synchronize()
        if [len(v) for v in captured.values()] != list(limits.values()):
            raise SystemExit(f"capture saw {[len(v) for v in captured.values()]} calls")
        captured["gather"] = captured["gather"][:1] + captured["gather"][2:]
        return captured

    def timed_gather(path, label, src, idx):
        """One gather timed beside its plain version, index_select and its
        bandwidth bound, with the launch plan it ran; one kernel_shape line."""
        lib_idx = idx.clamp(0, src.shape[0] - 1).long()
        nbytes = gather_bytes(torch, src, idx)
        plan = eg.launch_plan(idx.numel(), src.shape[1], src.element_size(),
                              eg.vector_aligned(src, eg.embedding_gather(src, idx)))
        row = {
            "kernel": "embedding_gather", "call": label, "src_rows": src.shape[0],
            "n": idx.numel(), "dim": src.shape[1],
            "dtype": str(src.dtype).removeprefix("torch."), "bytes": nbytes,
            "plan": {"chunk_bytes": plan.chunk_bytes, "rows_per_warp": plan.rows_per_warp,
                     "blocks": plan.blocks, "warps_per_block": plan.warps_per_block,
                     "vec_bytes": plan.vec_bytes},
            "ms": time_ms(torch, lambda: eg.embedding_gather(src, idx), flush),
            "plain_ms": time_ms(torch, lambda: ref.gather_rows_ref(src, idx), flush),
            "library_ms": time_ms(
                torch, lambda: torch.index_select(src, 0, lib_idx), flush),
            "bound_ms": nbytes / peak * 1e3,
            # the same two after a flush that leaves the L2 clean
            "clean_l2_ms": time_ms(torch, lambda: eg.embedding_gather(src, idx), flush,
                                   clean=True),
            "clean_l2_library_ms": time_ms(
                torch, lambda: torch.index_select(src, 0, lib_idx), flush, clean=True),
        }
        row["bound_over_ms"] = row["bound_ms"] / row["ms"]
        emit("kernel_shape", path=path, **row)
        return row

    serve_gather_labels = [f"{step} {part}" for step in ("prefill", "decode")
                           for part in ("retrieve", "assemble-1", "assemble-2")]

    def serve_keeping_gathers(table, serve):
        """``serve()`` with the gathers of its first two lookups kept: the
        prefill's (the f32 master retrieve, then two bf16 assembly gathers)
        and the first decode step's. The master is kept by reference, every
        other tensor copied. Returns (serve's result, the kept gathers, the
        number of gathers made)."""
        kept, calls = [], [0]
        real = dispatch.gather_rows

        def spy(rows, idx):
            if calls[0] < len(serve_gather_labels):
                kept.append((rows if rows is table.rows else rows.clone(), idx.clone()))
            calls[0] += 1
            return real(rows, idx)

        dispatch.gather_rows = spy
        try:
            out = serve()
        finally:
            dispatch.gather_rows = real
        return out, kept, calls[0]

    def check_serve_gathers(path, kept, n_calls, lookups, table):
        """A serve's kept gathers, at the path's own shapes, bit-exact
        against the plain version and timed; 3 gathers a lookup, each
        lookup retrieving from the master. Returns the timing rows."""
        if n_calls != 3 * lookups:
            raise SystemExit(f"the {path} warm-up serve made {n_calls} gathers")
        if kept[0][0] is not table.rows or kept[3][0] is not table.rows:
            raise SystemExit(f"the {path} lookups did not retrieve from the master")
        rows = []
        for label, (src, idx) in zip(serve_gather_labels, kept):
            check_gather(f"{path} {label}", src, idx)
            rows.append(timed_gather(path, label, src, idx))
        return rows

    def serve_gather_times(rows, decode_steps):
        """One serve's gathers: the prefill's lookup and decode_steps
        decode-step lookups, each timed at the first decode step's calls."""
        times = ("ms", "plain_ms", "library_ms", "bound_ms")
        prefill = {k: sum(x[k] for x in rows[:3]) for k in times}
        decode_step = {k: sum(x[k] for x in rows[3:]) for k in times}
        return {**{k: prefill[k] + decode_steps * decode_step[k] for k in times},
                "prefill": prefill, "decode_step": decode_step,
                "calls": f"the prefill's {', '.join(x['call'] for x in rows[:3])}; "
                         f"{decode_steps} x the first decode step's"}

    def check_and_time(path, captured, master):
        """Every captured call checked against its plain version (as at the
        edges) and timed beside the plain version, one PyTorch library call
        where there is one, and its bandwidth bound; one kernel_shape line
        each. Returns the rows by kernel."""
        shapes = {k: [] for k in mods}

        def timed(kernel, label, nbytes, fn, plain, library, **extra):
            row = {"kernel": kernel, "call": label, **extra, "bytes": nbytes,
                   "ms": time_ms(torch, fn, flush),
                   "plain_ms": time_ms(torch, plain, flush),
                   "library_ms": time_ms(torch, library, flush) if library else None,
                   "bound_ms": nbytes / peak * 1e3}
            shapes[kernel].append(row)
            emit("kernel_shape", path=path, **row)

        gather_labels = ["retrieve"] + [f"mb{i}-{part}" for i in range(N_MICRO)
                                        for part in ("serve", "assemble-1", "assemble-2")]
        for label, (src, idx) in zip(gather_labels, captured["gather"]):
            check_gather(label, src, idx)
            shapes["embedding_gather"].append(timed_gather(path, label, src, idx))

        seg_labels = [f"grads_to_owner-mb{i}" for i in range(N_MICRO)] + ["window-to-buffer"]
        for label, (grads, ids, segments) in zip(seg_labels, captured["segment"]):
            check_segment(label, grads, ids, segments, integer=False)
            integral = torch.randint(-8, 8, grads.shape, device=dev, generator=g,
                                     dtype=torch.float32)
            check_segment(label + "-integer", integral, ids, segments, integer=True)
            del integral
            kept = (ids >= 0) & (ids < segments)
            lib_ids, lib_grads = ids[kept].long(), grads[kept]
            run_counts = torch.bincount(lib_ids, minlength=segments)
            # the op's parts, each timed alone on this call's inputs
            sorted_ids, perm = sr.sort_ids(ids)
            starts = sr.find_starts(sorted_ids, segments)
            out, partial = sr.sum_chunks(grads, sorted_ids, perm, starts, segments)
            parts = {
                "sort": time_ms(torch, lambda: sr.sort_ids(ids), flush),
                "starts": time_ms(torch, lambda: sr.find_starts(sorted_ids, segments), flush),
                "sum": time_ms(torch, lambda: sr.sum_chunks(grads, sorted_ids, perm, starts,
                                                            segments), flush),
                "combine": time_ms(torch, lambda: sr.combine(out, partial, sorted_ids, starts),
                                   flush)}
            # chunks after a run's first: the stripes the combine reads
            extra_chunks = int(((run_counts - 1).clamp(min=0) // sr.CHUNK).sum())
            del sorted_ids, perm, starts, out, partial
            timed("segment_rowsum", label, segment_bytes(grads, ids, segments),
                  lambda: sr.segment_rowsum(grads, ids, segments),
                  lambda: ref.segment_rowsum_ref(grads, ids, segments),
                  lambda: torch.zeros((segments, grads.shape[1]), device=dev)
                  .index_add_(0, lib_ids, lib_grads),
                  L=ids.numel(), S=segments, dim=grads.shape[1],
                  in_range=lib_ids.numel(), longest_run=int(run_counts.max()),
                  extra_chunks=extra_chunks, parts_ms=parts,
                  library_call="index_add_ of the in-range rows only, "
                  "selected beforehand")
            del lib_ids, lib_grads

        (act, aa, pre, pa, src), = captured["sync"]
        check_sync("sync", act, aa, pre, pa, src)
        timed("buffer_sync", "sync", sync_bytes(act, pre, src),
              lambda: bs.buffer_sync(act, aa, pre, pa, src),
              lambda: ref.buffer_sync_ref(act, aa, pre, pa, src), None,
              Ka=act.shape[0], Kp=pre.shape[0], dim=pre.shape[1],
              hits=int((src < act.shape[0]).sum()))

        (_, _, idx, rows, accum), = captured["scatter"]
        # correctness at this call's n and D on a K-row stand-in (the write
        # pattern of the real master cannot be compared against a copy of it)
        valid = (idx >= 0) & (idx < master.rows.shape[0])
        k = idx.numel()
        proxy_idx = torch.where(valid, torch.randperm(k, device=dev, generator=g)
                                .to(torch.int32), k + 7)
        check_scatter("writeback-standin", torch.randn((k, rows.shape[1]), device=dev),
                      torch.rand(k, device=dev), proxy_idx, rows, accum)
        # timing on the real master, writing back the rows it holds now: the
        # write is real and leaves the master unchanged
        cur_rows = ref.gather_rows_ref(master.rows, idx)
        cur_acc = torch.where(valid, master.accum[idx.clamp(0, master.rows.shape[0] - 1)
                                                 .long()], 0.0)
        lib_dst = idx[valid].long()
        lib_rows = cur_rows[valid]
        timed("embedding_scatter", "writeback", scatter_bytes(master.rows, idx),
              lambda: es.embedding_scatter(master.rows, master.accum, idx, cur_rows,
                                           cur_acc),
              lambda: ref.embedding_scatter_ref(master.rows, master.accum, idx,
                                                cur_rows, cur_acc),
              lambda: master.rows.index_copy_(0, lib_dst, lib_rows),
              table_rows=master.rows.shape[0], n=k, valid=int(valid.sum()),
              dim=rows.shape[1], library_call="index_copy_ of the rows only, "
              "valid indices selected beforehand")
        if not torch.equal(ref.gather_rows_ref(master.rows, idx), cur_rows):
            raise SystemExit(f"the write-back timing changed the {path} master")
        torch.cuda.synchronize()
        return shapes

    shapes = check_and_time("dlrm_train", capture_calls(sess), sess.state.table)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 5. main path: training --------------------------------------------
    # rows of the first counted window, before and after
    stream = resolve_stream(wl, sess.seed, start_step=int(sess.state.step))
    first = make_cluster_transform(N_MICRO, wl.npcfg.clustering)(next(stream))
    keys0 = torch.as_tensor(first["keys"], device=dev)
    bkeys = wl.engine.route_window(keys0, N_MICRO).buffer_keys
    bkeys = bkeys[bkeys != SENTINEL]
    sample = bkeys[torch.randperm(bkeys.numel(), device=dev, generator=g)[:4096]].long()
    rows_before = sess.state.table.rows[sample].clone()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    rep = sess.train(TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_launches = counts()
    s = rep.summary
    table = sess.state.table
    changed = float((table.rows[sample] != rows_before).any(-1).float().mean())
    emit("train", arch=ARCH, mode="nestpipe", global_batch=TRAIN_BATCH,
         n_micro=N_MICRO, bucket_slack=SLACK, steps=TRAIN_STEPS,
         losses=rep.stats.losses, overflow_max=s["overflow_max"],
         samples_per_s=TRAIN_BATCH * TRAIN_STEPS / wall, wall_s=wall,
         step_ms=[x * 1e3 for x in rep.stats.step_times],
         step_p50_ms=s["p50_step_s"] * 1e3, step_p99_ms=s["p99_step_s"] * 1e3,
         mean_input_wait_ms=s["mean_input_wait_s"] * 1e3,
         stage_host_ms={k: s[k] for k in ("plan_ms", "retrieve_ms", "commit_ms")},
         launches=train_launches, window0_rows_changed=changed,
         table_device=str(table.rows.device), table_rows=table.rows.shape[0],
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    if not all(np.isfinite(rep.stats.losses)) or len(rep.stats.losses) != TRAIN_STEPS:
        raise SystemExit(f"training losses are not {TRAIN_STEPS} finite values")
    if s["overflow_max"] != 0:
        raise SystemExit(f"routing overflowed during training: {s['overflow_max']}")
    if table.rows.device.type != "cuda" or table.rows.shape[0] != 57_012_000:
        raise SystemExit("the dlrm-ctr master is not the full table on the card")
    if changed < 0.99:
        raise SystemExit(f"only {changed:.4f} of window 0's sampled rows changed")
    want = {"embedding_gather": (1 + 3 * N_MICRO) * TRAIN_STEPS,
            "segment_rowsum": (N_MICRO + 1) * TRAIN_STEPS,
            "buffer_sync": TRAIN_STEPS - 1, "embedding_scatter": TRAIN_STEPS,
            "hstu_attention_fwd": 0, "hstu_attention_bwd": 0,
            "flash_attention_wgmma": 0, "flash_attention_simple": 0,
            "flash_attention_tf32x3": 0, "flash_attention_bwd_tf32x3": 0,
            "flash_attention_bwd_simple": 0, "flash_attention_bwd_wgmma": 0}
    if train_launches != want:
        raise SystemExit(f"training launches {train_launches} != {want}")

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.core.dbp import pipeline as dbp
        from repro_torch.core.store import DeviceStore, Prefetcher

        spent = {}

        def clocked(fn, key):
            def run(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    spent[key] = spent.get(key, 0.0) + time.perf_counter() - t
            return run

        fns = sess.fns
        wrapped = [(Prefetcher, "fill"), (DeviceStore, "commit"),
                   (dbp._MetricsDrain, "drain")]
        originals = [getattr(c, m) for c, m in wrapped]
        for (c, m), fn in zip(wrapped, originals):
            setattr(c, m, clocked(fn, f"{c.__name__}.{m}"))
        sess._fns = fns._replace(
            window_step=clocked(fns.window_step, "window_step"),
            sync_buffers=clocked(fns.sync_buffers, "sync_buffers"))
        try:
            t0 = time.perf_counter()
            sess.train(4)
            torch.cuda.synchronize()
            span = time.perf_counter() - t0
        finally:
            for (c, m), fn in zip(wrapped, originals):
                setattr(c, m, fn)
            sess._fns = fns
        # what the data thread does per batch, alone: draw it, cluster it
        gen = resolve_stream(wl, sess.seed, start_step=1000)
        transform = make_cluster_transform(N_MICRO, wl.npcfg.clustering)
        batch_ms = []
        for _ in range(3):
            t = time.perf_counter()
            transform(next(gen))
            batch_ms.append((time.perf_counter() - t) * 1e3)
        emit("train_host_breakdown", steps=4, wall_ms=span * 1e3,
             **{f"{k}_ms": v * 1e3 for k, v in spent.items()},
             host_batch_ms=statistics.median(batch_ms))

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sess.train(4)
            torch.cuda.synchronize()
            span = time.perf_counter() - t0
        emit_profile(prof, "train_profile", span, steps=4)

    # -- 6. main path: serving the trained weights --------------------------
    model, table = sess.weights()
    swl = resolve(ARCH, device=dev, mode="serve", npcfg=InferenceStrategy()
                  .configure(wl.npcfg), global_batch=MAX_BATCH)
    reqs = synthetic_requests(swl, MAX_BATCH, seed=0)
    keys = torch.as_tensor(np.stack([k for k, _ in reqs]),
                           device=dev).reshape(1, MAX_BATCH, -1)
    with torch.inference_mode():
        window = swl.engine.route_window(keys, 1)
        plan = LookupPlan(*(x[0] for x in window.plans))
        bkeys = window.buffer_keys
        master_idx = torch.where(bkeys != SENTINEL, bkeys, swl.spec.padded_rows)
        buf_rows = check_gather("retrieve", table.rows, master_idx)
        buf_idx = sorted_lookup(bkeys, plan.recv_keys.reshape(-1))
        served = check_gather("serve-from-buffer", buf_rows, buf_idx)
        unique_emb = check_gather("assemble-1", served, plan.slot_of_unique)
        check_gather("assemble-2", unique_emb, plan.inverse)

    serve_shapes = [timed_gather("dlrm_serve", label, src, idx) for label, src, idx in (
        ("retrieve", table.rows, master_idx), ("serve-from-buffer", buf_rows, buf_idx),
        ("assemble-1", served, plan.slot_of_unique), ("assemble-2", unique_emb, plan.inverse))]

    # one unchecked warm-up pass, then the counted one
    sess.serve_embeddings(num_requests=2 * MAX_BATCH, max_batch=MAX_BATCH,
                          head="dlrm")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    srep = sess.serve_embeddings(num_requests=N_REQUESTS, max_batch=MAX_BATCH,
                                 head="dlrm", check_exact=True)
    wall = time.perf_counter() - t0
    serve_launches = counts()
    s = srep.summary
    windows = int(s["windows"])
    chunks = -(-N_REQUESTS // MAX_BATCH)
    emit("serve", arch=ARCH, head="dlrm", weights="trained", requests=N_REQUESTS,
         max_batch=MAX_BATCH, windows=windows, qps=s["qps"],
         latency_p50_ms=s["latency_p50_ms"], latency_p99_ms=s["latency_p99_ms"],
         serve_wall_s=s["wall_s"], total_wall_s=wall,
         exact=s["exact"], max_abs_diff=s["max_abs_diff"],
         launches=serve_launches, ground_truth_chunks=chunks,
         table_device=str(table.rows.device), table_rows=table.rows.shape[0],
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    if s["exact"] != 1:
        raise SystemExit(f"served logits differ from the master ground truth: {s}")
    if table is not sess.state.table:
        raise SystemExit("serving did not read the trained master")
    if serve_launches["embedding_gather"] != 4 * windows + 3 * chunks:
        raise SystemExit(f"gather launches {serve_launches} != 4 x {windows} "
                         f"windows + 3 x {chunks} ground-truth chunks")
    if srep.results.shape != (N_REQUESTS,) or not np.isfinite(srep.results).all():
        raise SystemExit("served logits are not finite of shape (requests,)")

    if args.profile:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sess.serve_embeddings(num_requests=N_REQUESTS, max_batch=MAX_BATCH,
                                  head="dlrm")
            torch.cuda.synchronize()
            span = time.perf_counter() - t0
        emit_profile(prof, "serve_profile", span, requests=N_REQUESTS)
    del sess, model, table, state, rep, srep
    gc.collect()
    torch.cuda.empty_cache()

    def window_keys(sess, start, steps):
        """The keys the windows of steps [start, start + steps) of the
        session's stream (its data seed) touch, unique."""
        stream = resolve_stream(sess.workload, sess.data_seed, start_step=start)
        transform = make_cluster_transform(N_MICRO, sess.workload.npcfg.clustering)
        keys = []
        for _ in range(steps):
            bk = sess.workload.engine.route_window(
                torch.as_tensor(transform(next(stream))["keys"], device=dev),
                N_MICRO).buffer_keys
            keys.append(bk[bk != SENTINEL])
        return torch.unique(torch.cat(keys)).long()

    def final_state(state, touched, sampled):
        """What a run is held to, on the host: the rows and adagrad state
        at the touched and the sampled keys, the dense params and the
        optimizer state."""
        return {"touched_rows": state.table.rows[touched].cpu(),
                "touched_accum": state.table.accum[touched].cpu(),
                "sampled_rows": state.table.rows[sampled].cpu(),
                "sampled_accum": state.table.accum[sampled].cpu(),
                "dense_and_optimizer": [(k, t.cpu()) for k, t in
                                        flatten_state(state._replace(table=None))]}

    def same_final(got, want):
        """Bit for bit, by part, two ``final_state`` results."""
        out = {k: torch.equal(got[k], want[k]) for k in want if k != "dense_and_optimizer"}
        g, w = got["dense_and_optimizer"], want["dense_and_optimizer"]
        out["dense_and_optimizer"] = [k for k, _ in g] == [k for k, _ in w] \
            and all(torch.equal(t, u) for (_, t), (_, u) in zip(g, w))
        return out

    # -- 6a. full-width dlrm-ctr training through the host and cached tiers
    # the same seed and steps through each tier, then the device tier: the
    # same losses and the same master rows and adagrad state, bit for bit,
    # at every key the steps touched
    tier_kw = dict(mode="nestpipe", global_batch=TRAIN_BATCH, n_micro=N_MICRO,
                   bucket_slack=SLACK, seed=0)
    touched = []  # the host tier's buffer keys, window by window
    seen = {}  # what the wrapped store methods saw in the current run
    # --profile: a record_function range from a run's first stage after its
    # ingest to its release, the window its device idle share is read over
    marker = {"on": False, "range": None}
    real_tier = {m: getattr(HostStore, m)
                 for m in ("ingest", "route", "plan_from_window", "release")}

    def tier_ingest(self, table):
        t = time.perf_counter()
        out = real_tier["ingest"](self, table)
        torch.cuda.synchronize()
        seen.update(ingest_s=time.perf_counter() - t, fresh=True)
        return out

    def tier_route(self, keys):
        if seen.pop("fresh", False):
            # the run's first stage after ingest (on the driver thread in
            # every mode): the device master is gone
            torch.cuda.synchronize()
            seen["device_gb_running"] = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            if marker["on"]:
                marker["range"] = torch.profiler.record_function("tier_steady")
                marker["range"].__enter__()
        return real_tier["route"](self, keys)

    def tier_plan(self, window, after=None):
        plan = real_tier["plan_from_window"](self, window, after)
        if run_name == "host":
            touched.append(plan.host_keys.copy())
        return plan

    def tier_release(self):
        torch.cuda.synchronize()
        if marker["range"] is not None:
            marker["range"].__exit__(None, None, None)
            marker["range"] = None
        seen.update(peak_device_gb_running=torch.cuda.max_memory_allocated() / 1e9,
                    master_pinned=self.rows.is_pinned() and self.accum.is_pinned(),
                    master_device=str(self.rows.device),
                    master_gb=self.memory_bytes() / 1e9)
        t = time.perf_counter()
        out = real_tier["release"](self)
        torch.cuda.synchronize()
        seen["release_s"] = time.perf_counter() - t
        return out

    # the cached tier's device work, labelled by the store method it runs in:
    # one call of each kept (the third, when the run has one; an eviction's
    # first), every tensor by reference (only the cache is written later)
    cached_calls = {}  # run -> label -> [(kind, args)]
    run_name = None
    label = []
    nth = {}

    def labelled(fn, name):
        def run(self, *a, **kw):
            nth[name] = nth.get(name, -1) + 1
            if name == "evict" and nth[name] > 0 or name != "evict" and nth[name] > 2:
                label.append(None)
            else:
                label.append(name)
                cached_calls[run_name][name] = []
            try:
                return fn(self, *a, **kw)
            finally:
                label.pop()
        return run

    def captured(kind, fn):
        def run(*a):
            if label and label[-1] is not None:
                cached_calls[run_name][label[-1]].append((kind, a))
            return fn(*a)
        return run

    class HookedStrategy:
        """A session's strategy whose drivers get the executor's hooks."""

        def __init__(self, inner, hooks):
            self.inner, self.hooks, self.name = inner, hooks, inner.name

        def build_driver(self, fns, stream, workload, **kw):
            return self.inner.build_driver(fns, stream, workload,
                                           stage_hooks=self.hooks, **kw)

    def tier_run(run, store, capture=True, hooks=None, **kw):
        nonlocal run_name
        run_name = run
        base_gb = torch.cuda.memory_allocated() / 1e9
        tsess = Session.from_arch(ARCH, store=store, **tier_kw, **kw)
        warm_losses = tsess.train(1).stats.losses  # the report holds the table
        torch.cuda.synchronize()
        warm_seen = dict(seen)
        seen.clear()
        patched = []
        if hooks is not None:
            tsess.strategy = HookedStrategy(tsess.strategy, hooks)
        if store == "cached" and capture:
            nth.clear()
            cached_calls[run] = {}
            patched = [(CachedStore, m, getattr(CachedStore, m)) for m in
                       ("_assemble", "_admit_chunks", "_writeback_chunks", "_commit_body")]
            for (c, m, fn), name in zip(patched, ("assemble", "admit", "evict", "commit")):
                setattr(c, m, labelled(fn, name))
            patched += [(dispatch, m, getattr(dispatch, m)) for m in
                        ("gather_rows", "scatter_rows")]
            dispatch.gather_rows = captured("gather", patched[-2][2])
            dispatch.scatter_rows = captured("scatter", patched[-1][2])
        host0 = torch.cuda.host_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        try:
            trep = tsess.train(TIER_STEPS)
            torch.cuda.synchronize()
        finally:
            for c, m, fn in patched:
                setattr(c, m, fn)
            tsess.strategy = getattr(tsess.strategy, "inner", tsess.strategy)
        wall = time.perf_counter() - t0
        host1 = torch.cuda.host_memory_stats()
        launches = counts()
        s = trep.summary
        m = trep.stats.store_metrics
        row = {"run": run, "store": store, "steps": TIER_STEPS, "warmup_steps": 1,
               "losses": trep.stats.losses, "overflow_max": s["overflow_max"],
               "samples_per_s": TRAIN_BATCH * TIER_STEPS / wall, "wall_s": wall,
               # the steps alone (the device-timeline spans), without the
               # run's ingest and release of the master
               "samples_per_s_in_steps": TRAIN_BATCH * len(trep.stats.step_times)
               / sum(trep.stats.step_times),
               "step_ms": [x * 1e3 for x in trep.stats.step_times],
               "step_p50_ms": s["p50_step_s"] * 1e3, "step_p99_ms": s["p99_step_s"] * 1e3,
               "stage_host_ms_per_step": {k: s[k] / TIER_STEPS for k in
                                          ("plan_ms", "retrieve_ms", "commit_ms", "h2d_ms")},
               "launches": launches, "device_gb_before_session": base_gb, **seen,
               "warmup_ingest_s": warm_seen.get("ingest_s"),
               "warmup_release_s": warm_seen.get("release_s")}
        if store != "device":
            row.update({k: m.get(k) for k in (
                "h2d_bytes", "d2h_bytes", "h2d_copy_ms", "d2h_copy_ms", "wire_bytes",
                "idx_bytes", "h2d_bursts", "d2h_bursts", "cache_evictions",
                "cache_hits", "cache_misses", "cache_admissions", "cache_rows_used",
                "cache_capacity")})
            row.update({f"{w}_gb_per_s": m[f"{w}_bytes"] / m[f"{w}_copy_ms"] / 1e6
                        if m[f"{w}_copy_ms"] else None for w in ("h2d", "d2h")})
            row.update({k: s.get(k) for k in ("cache_hit_rate", "cache_hit_rate_steady")})
        row.update(cache_rows=kw.get("cache_rows"), cache_policy=kw.get("cache_policy"),
                   async_stages=s["async_stages"], sparse_comm=s["sparse_comm"],
                   stage_workers=kw.get("stage_workers", 1),
                   prefetch_ahead=kw.get("prefetch_ahead", 1),
                   buffer_sync_launches=launches["buffer_sync"],
                   straggler_steps=trep.stats.straggler_steps,
                   **{k: s[k] for k in ("async_repairs_at_commit", "async_repairs_deferred",
                                        "async_repairs_ring", "comm_rows_synced",
                                        "comm_rows_deferred", "faults_injected",
                                        "stage_retries", "commit_rollbacks",
                                        "stragglers_flagged") if k in s})
        # pinned host memory the counted steps allocated: the caching host
        # allocator's new blocks (cudaHostAlloc)
        row["host_alloc_in_counted_steps"] = {
            k: host1[k] - host0.get(k, 0) for k in (
                "num_host_alloc", "num_host_free", "host_alloc_time.total",
                "allocated_bytes.allocated", "reserved_bytes.current")
            if k in host1}
        row["host_pinned_allocated_gb"] = torch.cuda.host_memory_stats().get(
            "allocated_bytes.current", 0) / 1e9
        emit("tier_train", arch=ARCH, global_batch=TRAIN_BATCH, n_micro=N_MICRO,
             bucket_slack=SLACK, **row)
        if not all(np.isfinite(trep.stats.losses)) or s["overflow_max"] != 0:
            raise SystemExit(f"the {store} tier's losses or routing are off: {s}")
        return tsess, warm_losses + trep.stats.losses, row

    tier_patches = (("ingest", tier_ingest), ("route", tier_route),
                    ("plan_from_window", tier_plan), ("release", tier_release))
    for m, fn in tier_patches:
        setattr(HostStore, m, fn)
    try:
        tiers, chaos_ref = {}, {}
        for run, store, kw in TIER_RUNS:
            tsess, losses, row = tier_run(run, store, **kw)
            if run == "host":
                keys_t = np.unique(np.concatenate(touched))
                keys_t = torch.from_numpy(keys_t[keys_t != SENTINEL].astype(np.int64)).to(dev)
                # a generator of its own: the later phases' draws stay as they were
                keys_s = torch.randint(0, tsess.workload.spec.padded_rows, (SAMPLED_KEYS,),
                                       device=dev, generator=torch.Generator(dev).manual_seed(6))
            table = tsess.state.table
            tiers[run] = (losses, table.rows[keys_t], table.accum[keys_t], row)
            if run in ("host", "cached-evicting"):  # what 6h's chaos runs are held to
                chaos_ref[run] = {"losses": losses, "row": row,
                                  "final": final_state(tsess.state, keys_t, keys_s)}
            del table  # the next run of this session frees it
            gc.collect()
            torch.cuda.empty_cache()
            if args.profile and run in ("host", "cached"):
                # 4 more steps, after the comparison's rows were taken
                marker["on"] = True
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    tsess.train(4)
                    torch.cuda.synchronize()
                    span = time.perf_counter() - t0
                marker["on"] = False
                emit_profile(prof, "tier_profile", span, window="tier_steady",
                             run=run, steps=4)
                del prof
            if run == "cached":
                csess = tsess  # serves in 6c
            del tsess
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        for m, fn in real_tier.items():
            setattr(HostStore, m, fn)
    # what 6e and 6f hold their runs to: each tier's synchronous run
    sync_ref = {run: tiers[run] for run in ("host", "cached", "cached-evicting")}
    dev_losses, dev_rows, dev_accum, _ = tiers["device"]
    same = {run: {"losses": tiers[run][0] == dev_losses,
                  "rows": torch.equal(tiers[run][1], dev_rows),
                  "accum": torch.equal(tiers[run][2], dev_accum)}
            for run in tiers if run != "device"}
    emit("tier_consistency", arch=ARCH, steps=1 + TIER_STEPS,
         touched_keys=keys_t.numel(), equal_to_device_tier=same,
         device_losses=dev_losses)
    for run in same:
        row = tiers[run][3]
        if not all(same[run].values()):
            raise SystemExit(f"the {run} run differs from the device tier: {same}")
        if not row["master_pinned"] or row["master_device"] != "cpu":
            raise SystemExit(f"the {run} run's master is not pinned host memory")
        # on the card: the dense model, the buffers and (cached) the cache
        cache_gb = (row["cache_capacity"] or 0) * (tier_dim * 4 + 4) / 1e9
        if row["device_gb_running"] - row["device_gb_before_session"] > cache_gb + 1.0:
            raise SystemExit(f"the {run} run holds more than its cache on the card: {row}")
    if tiers["cached-evicting"][3]["cache_evictions"] == 0:
        raise SystemExit("the full-width cached run with a small cache evicted nothing")
    host_train_launches = tiers["host"][3]["launches"]
    cached_train_launches = tiers["cached"][3]["launches"]
    del tiers, dev_rows, dev_accum
    gc.collect()
    torch.cuda.empty_cache()

    # -- 6b. the cached path's kernel calls, checked and timed ---------------
    need = {"assemble": ("gather",) * 4, "admit": ("gather", "gather", "scatter"),
            "evict": ("gather", "gather"), "commit": ("scatter",)}
    calls_of = {lab: cached_calls["cached-evicting" if lab == "evict" else "cached"]
                .get(lab, []) for lab in need}
    for lab, kinds in need.items():
        got = tuple(k for k, _ in calls_of[lab])
        if got[:len(kinds)] != kinds:
            raise SystemExit(f"the cached tier's {lab} ran {got}, not {kinds}")
    cached_shapes = {"embedding_gather": [], "embedding_scatter": []}
    for lab in need:
        for kind, a in calls_of[lab]:
            if kind == "gather":
                src, idx = a
                call = f"{lab}: {idx.numel():,} of {src.shape[0]:,} x {src.shape[1]}"
                check_gather(call, src, idx)
                cached_shapes["embedding_gather"].append(
                    timed_gather("dlrm_cached_train", call, src, idx))
                continue
            cache, cache_acc, idx, rows, accum = a
            call = f"{lab}: {idx.numel():,} slots into {cache.shape[0]:,} x {cache.shape[1]}"
            check_scatter(call, cache, cache_acc, idx, rows, accum)
            work, work_acc = cache.clone(), cache_acc.clone()
            valid = (idx >= 0) & (idx < cache.shape[0])
            lib_dst, lib_rows = idx[valid].long(), rows[valid]
            nbytes = scatter_bytes(cache, idx)
            row = {"kernel": "embedding_scatter", "call": call, "table_rows": cache.shape[0],
                   "n": idx.numel(), "valid": int(valid.sum()), "dim": rows.shape[1],
                   "bytes": nbytes,
                   "ms": time_ms(torch, lambda: es.embedding_scatter(
                       work, work_acc, idx, rows, accum), flush),
                   "plain_ms": time_ms(torch, lambda: ref.embedding_scatter_ref(
                       work, work_acc, idx, rows, accum), flush),
                   "library_ms": time_ms(torch, lambda: work.index_copy_(0, lib_dst, lib_rows),
                                         flush),
                   "library_call": "index_copy_ of the rows only, valid indices "
                                   "selected beforehand",
                   "bound_ms": nbytes / peak * 1e3}
            cached_shapes["embedding_scatter"].append(row)
            emit("kernel_shape", path="dlrm_cached_train", **row)
            del work, work_acc, lib_dst, lib_rows
    del cached_calls, calls_of
    gc.collect()
    torch.cuda.empty_cache()

    # -- 6c. full-width serving through the cached tier ----------------------
    reset_counts()
    t0 = time.perf_counter()
    crep = csess.serve_embeddings(num_requests=N_REQUESTS, max_batch=MAX_BATCH,
                                  head="dlrm", check_exact=True)
    wall = time.perf_counter() - t0
    cached_serve_launches = counts()
    s = crep.summary
    emit("cached_serve", arch=ARCH, store=s["store"], head="dlrm",
         weights="trained through the cached tier", requests=N_REQUESTS,
         max_batch=MAX_BATCH, windows=int(s["windows"]), qps=s["qps"],
         latency_p50_ms=s["latency_p50_ms"], latency_p99_ms=s["latency_p99_ms"],
         serve_wall_s=s["wall_s"], total_wall_s=wall, exact=s["exact"],
         max_abs_diff=s["max_abs_diff"], read_horizon=True,
         **{k: s.get(k) for k in ("cache_hit_rate", "cache_hits", "cache_misses",
                                  "cache_admissions", "cache_evictions", "h2d_bytes",
                                  "d2h_bytes", "h2d_bursts", "h2d_copy_ms",
                                  "retrieve_ms", "plan_ms")},
         launches=cached_serve_launches)
    if s["exact"] != 1 or s["store"] != "frozen-cached":
        raise SystemExit(f"the cached tier did not serve the master exactly: {s}")
    if crep.results.shape != (N_REQUESTS,) or not np.isfinite(crep.results).all():
        raise SystemExit("served logits are not finite of shape (requests,)")
    # the same master served again with the pack wire mode: the same bits
    reset_counts()
    prep = csess.serve_embeddings(num_requests=N_REQUESTS, max_batch=MAX_BATCH,
                                  head="dlrm", sparse_comm="pack", check_exact=True)
    cached_pack_serve_launches = counts()
    ps = prep.summary
    emit("cached_serve_pack", arch=ARCH, store=ps["store"], sparse_comm=ps["sparse_comm"],
         requests=N_REQUESTS, max_batch=MAX_BATCH, qps=ps["qps"],
         latency_p50_ms=ps["latency_p50_ms"], latency_p99_ms=ps["latency_p99_ms"],
         exact=ps["exact"], max_abs_diff=ps["max_abs_diff"],
         same_results_as_off=bool(np.array_equal(prep.results, crep.results)),
         **{f"{k}_pack": ps.get(k) for k in ("wire_bytes", "idx_bytes", "h2d_bytes")},
         **{f"{k}_off": s.get(k) for k in ("wire_bytes", "idx_bytes", "h2d_bytes")},
         launches=cached_pack_serve_launches)
    if ps["exact"] != 1 or ps["sparse_comm"] != "pack":
        raise SystemExit(f"the cached tier did not serve exactly under pack: {ps}")
    del csess, crep, prep
    gc.collect()
    torch.cuda.empty_cache()

    # -- 6d. every cache policy on the card replays the host tier -------------
    policy_runs = []
    for parch in POLICY_ARCHS:
        pkw = dict(mode="nestpipe", global_batch=POLICY_BATCH, n_micro=N_MICRO, seed=0)
        init = clone_state(Session.from_arch(parch, **pkw).state)
        host = Session.from_arch(parch, store="host", **pkw)
        host.state = clone_state(init)
        hrep = host.train(POLICY_STEPS)
        for pol in CACHE_POLICIES:
            csess = Session.from_arch(parch, store="cached", cache_rows=POLICY_CACHE_ROWS,
                                      cache_policy=pol, **pkw)
            csess.state = clone_state(init)
            prep = csess.train(POLICY_STEPS)
            m = prep.stats.store_metrics
            same = (prep.stats.losses == hrep.stats.losses
                    and torch.equal(csess.state.table.rows, host.state.table.rows)
                    and torch.equal(csess.state.table.accum, host.state.table.accum))
            policy_runs.append({
                "arch": parch, "policy": pol, "equal_to_host_tier": same,
                "cache_hit_rate": prep.summary.get("cache_hit_rate"),
                "cache_hit_rate_steady": prep.summary.get("cache_hit_rate_steady"),
                **{k: m[k] for k in ("cache_evictions", "cache_admissions", "h2d_bursts",
                                     "d2h_bursts", "cache_hits", "cache_misses")}})
            if not same:
                raise SystemExit(f"{parch} under {pol} differs from the host tier")
            if m["cache_evictions"] == 0:
                raise SystemExit(f"{parch} under {pol} evicted nothing")
        del init, host, hrep, csess, prep
    emit("cache_policies", cache_rows=POLICY_CACHE_ROWS, global_batch=POLICY_BATCH,
         steps=POLICY_STEPS, runs=policy_runs)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 6e. the async stage executor at full width ---------------------------
    # -- 6f. the sparse-comm modes on the evicting cache, sync and async ------
    # each run as in 6a (one warm-up step, TIER_STEPS counted, seed 0), then
    # its losses and the rows and adagrad state of every touched key against
    # 6a's synchronous run of its tier (6f: of the evicting cache), bit for
    # bit (pack included); int8 reports its largest loss deviation from it
    race_log = []
    race_gate = threading.Event()

    def race_retrieve_start(w):
        if w == RACE_WINDOW and not race_gate.wait(timeout=120):
            raise RuntimeError(f"commit {RACE_COMMIT} was never submitted")
        race_log.append(("retrieve", w))

    def race_commit_submit(epoch):
        race_log.append(("commit_submit", epoch))
        if epoch == RACE_COMMIT:
            race_gate.set()

    race_hooks = {"retrieve_start": race_retrieve_start,
                  "commit_submit": race_commit_submit}
    side_keys = ("step_p50_ms", "step_p99_ms", "samples_per_s", "stage_host_ms_per_step",
                 "h2d_bytes", "d2h_bytes", "h2d_gb_per_s", "d2h_gb_per_s", "wire_bytes",
                 "idx_bytes", "buffer_sync_launches", "host_alloc_in_counted_steps")
    path_launches, exec_p50 = {}, {}
    exec_runs = {"async": [], "comm": []}
    for m, fn in tier_patches:
        setattr(HostStore, m, fn)
    try:
        for run, store, kw in ASYNC_RUNS + COMM_RUNS:
            comm_init = SparseComm.__init__
            if run == INT8_SYNC_ALL:
                SparseComm.__init__ = lambda self, mode=None, **ckw: comm_init(
                    self, mode, **{**ckw, "min_sync_p": 1.0})
            try:
                tsess, losses, row = tier_run(run, store, capture=False,
                                              hooks=race_hooks if "race" in run else None,
                                              **kw)
            finally:
                SparseComm.__init__ = comm_init
            ref_run = "cached-evicting" if "sparse_comm" in kw else store
            ref_losses, ref_rows, ref_accum, ref_row = sync_ref[ref_run]
            table = tsess.state.table
            same = {"losses": losses == ref_losses,
                    "rows": torch.equal(table.rows[keys_t], ref_rows),
                    "accum": torch.equal(table.accum[keys_t], ref_accum)}
            del table
            rec = {"run": run, "store": store, **kw, "sync_run": ref_run,
                   "equal_to_sync_run": same,
                   **{k: row.get(k) for k in side_keys},
                   **{k: row.get(k) for k in row if k.startswith(("async_repairs",
                                                                   "comm_rows"))},
                   "sync": {k: ref_row.get(k) for k in side_keys}}
            if kw.get("sparse_comm") == "int8":
                rec["max_loss_dev_from_off"] = max(abs(a - b) for a, b in
                                                   zip(losses, ref_losses))
                if not all(np.isfinite(losses)):
                    raise SystemExit(f"the {run} run's losses are not finite")
                if not row.get("comm_rows_synced"):
                    raise SystemExit(f"the {run} run synced no row selectively: {row}")
                if run == INT8_SYNC_ALL and row.get("comm_rows_deferred") != 0:
                    raise SystemExit(f"the {run} run deferred rows: {row}")
            elif not all(same.values()):
                raise SystemExit(f"the {run} run differs from 6a's {ref_run} run: {same}")
            if "race" in run:
                r = race_log.index(("retrieve", RACE_WINDOW))
                rec["race"] = {
                    "commits_submitted_before_gated_retrieve": sorted(
                        e for k, e in race_log[:r] if k == "commit_submit"),
                    "log": race_log[:r + 1]}
                if ("commit_submit", RACE_COMMIT) not in race_log[:r]:
                    raise SystemExit(f"the forced race did not happen: {race_log}")
                if row["buffer_sync_launches"] <= TIER_STEPS - 1 \
                        or not row.get("async_repairs_deferred"):
                    raise SystemExit(f"the forced race ran no deferred repairs: {row}")
            exec_runs["comm" if "sparse_comm" in kw else "async"].append(rec)
            path_launches[run] = row["launches"]
            exec_p50[run] = row["step_p50_ms"]
            if args.profile and run in ("host-async", "cached-async"):
                # 4 more steps, beside 6a's synchronous tier_profile lines
                marker["on"] = True
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    tsess.train(4)
                    torch.cuda.synchronize()
                    span = time.perf_counter() - t0
                marker["on"] = False
                emit_profile(prof, "tier_profile", span, window="tier_steady",
                             run=run, steps=4)
                del prof
            del tsess
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        for m, fn in real_tier.items():
            setattr(HostStore, m, fn)
    emit("async_stages", arch=ARCH, global_batch=TRAIN_BATCH, steps=1 + TIER_STEPS,
         touched_keys=keys_t.numel(), runs=exec_runs["async"])
    off = sync_ref["cached-evicting"][3]
    emit("sparse_comm", arch=ARCH, global_batch=TRAIN_BATCH, steps=1 + TIER_STEPS,
         runs=exec_runs["comm"],
         off={k: off.get(k) for k in side_keys},
         pack_over_off={k: next(r[k] for r in exec_runs["comm"]
                               if r["run"] == "cached-evicting-pack") / off[k]
                        for k in ("wire_bytes", "idx_bytes", "h2d_bytes", "d2h_bytes")
                        if off.get(k)})
    del sync_ref, exec_runs
    gc.collect()
    torch.cuda.empty_cache()

    # -- 6g. checkpoints at full width: save, restore, resume ---------------
    # A trains 5 steps and saves at step 3 through the driver's seam; B,
    # drawn from another seed, restores it and trains steps 4-5, which must
    # equal A's bit for bit. One master on the card at a time: A's goes
    # before B is drawn, and the restore copies into B's in place.
    t_phase = time.perf_counter()
    start_gb = torch.cuda.memory_allocated() / 1e9  # what earlier phases left
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    CKPT_DIR.mkdir(parents=True)
    ckpt_kw = dict(mode="nestpipe", global_batch=TRAIN_BATCH, n_micro=N_MICRO,
                   bucket_slack=SLACK, data_seed=0, ckpt_dir=str(CKPT_DIR))
    a = Session.from_arch(ARCH, seed=0, ckpt_every=CKPT_AT, **ckpt_kw)
    master_bytes = a.state.table.rows.numel() * 4
    need = sum(t.numel() * t.element_size() for _, t in flatten_state(a.state))
    free = shutil.disk_usage(CKPT_DIR).free
    if free < 1.05 * need:
        raise SystemExit(f"{CKPT_DIR} has {free} bytes free; one checkpoint and "
                         f"5% need {1.05 * need:.0f}")
    ckpt_io = {}

    def timed_io(kind, real):
        """The session's checkpoint call, timed (its own split into
        timings), with the device's peak memory over it."""
        def run(*a_, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tm = {}
            t0 = time.perf_counter()
            out = real(*a_, timings=tm, **kw)
            torch.cuda.synchronize()
            ckpt_io[kind] = {**tm, "seconds": time.perf_counter() - t0,
                             "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}
            return out
        return run

    real_io = {k: getattr(session_mod, k) for k in
               ("save_checkpoint", "restore_latest_verifiable")}
    session_mod.save_checkpoint = timed_io("save", real_io["save_checkpoint"])
    try:
        rep_a = a.train(CKPT_STEPS)
        torch.cuda.synchronize()
    finally:
        session_mod.save_checkpoint = real_io["save_checkpoint"]
    step_dir = CKPT_DIR / f"step_{CKPT_AT:08d}"
    ckpt_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
    manifest = json.loads((step_dir / "manifest.json").read_text())
    if sorted(os.listdir(CKPT_DIR)) != [step_dir.name] or manifest["step"] != CKPT_AT \
            or not all("crc32" in e for e in manifest["leaves"]):
        raise SystemExit(f"the checkpoint directory holds {os.listdir(CKPT_DIR)}, "
                         f"step {manifest['step']}")
    # what steps 4-5 wrote: the rows and adagrad state at their windows'
    # keys, the dense params and the optimizer state
    touched_ck = window_keys(a, CKPT_AT, CKPT_STEPS - CKPT_AT)
    # a generator of its own: the later phases' draws stay as they were
    untouched_ck = torch.randint(0, a.workload.spec.padded_rows, (SAMPLED_KEYS,), device=dev,
                                 generator=torch.Generator(dev).manual_seed(CKPT_AT))
    a_final = final_state(a.state, touched_ck, untouched_ck)
    a_losses, a_stats = rep_a.stats.losses, rep_a.stats
    a_summary = rep_a.summary
    del a, rep_a  # every reference to A's master
    gc.collect()
    torch.cuda.empty_cache()
    after_a_gb = torch.cuda.memory_allocated() / 1e9

    b = Session.from_arch(ARCH, seed=1, **ckpt_kw)
    session_mod.restore_latest_verifiable = timed_io(
        "restore", real_io["restore_latest_verifiable"])
    try:
        restored_at = b.restore_if_available()
    finally:
        session_mod.restore_latest_verifiable = real_io["restore_latest_verifiable"]
    if restored_at != CKPT_AT or int(b.state.step) != CKPT_AT:
        raise SystemExit(f"restore_if_available gave {restored_at}, step "
                         f"{int(b.state.step)}, not {CKPT_AT}")
    torch.cuda.synchronize()
    reset_counts()
    rep_b = b.train(CKPT_STEPS - CKPT_AT)
    torch.cuda.synchronize()
    ckpt_launches = counts()
    same = {"losses": rep_b.stats.losses == a_losses[CKPT_AT:],
            **same_final(final_state(b.state, touched_ck, untouched_ck), a_final)}
    after_save = [t for t in a_stats.straggler_steps if t >= CKPT_AT] \
        + rep_b.stats.straggler_steps
    save, restore = ckpt_io["save"], ckpt_io["restore"]
    ckpt_want = {"embedding_gather": (1 + 3 * N_MICRO) * (CKPT_STEPS - CKPT_AT),
                 "segment_rowsum": (N_MICRO + 1) * (CKPT_STEPS - CKPT_AT),
                 "buffer_sync": CKPT_STEPS - CKPT_AT - 1,
                 "embedding_scatter": CKPT_STEPS - CKPT_AT}
    emit("checkpoint", arch=ARCH, global_batch=TRAIN_BATCH, steps=CKPT_STEPS,
         saved_at=CKPT_AT, dir=str(CKPT_DIR), free_bytes=free,
         checkpoint_bytes=ckpt_bytes, checkpoint_gb=ckpt_bytes / 1e9,
         leaves=len(manifest["leaves"]), master_gb=master_bytes / 1e9,
         save_s=save["seconds"], save_d2h_s=save.get("d2h_s", 0.0),
         save_write_crc_s=save.get("write_s", 0.0),
         save_gb_per_s=ckpt_bytes / save["seconds"] / 1e9,
         save_d2h_gb_per_s=master_bytes / save["d2h_s"] / 1e9,
         save_write_crc_gb_per_s=ckpt_bytes / save["write_s"] / 1e9,
         save_peak_device_gb=save["peak_device_gb"],
         restore_s=restore["seconds"], restore_verify_s=restore["verify_s"],
         restore_load_h2d_s=restore["load_s"],
         restore_gb_per_s=ckpt_bytes / restore["seconds"] / 1e9,
         restore_verify_gb_per_s=ckpt_bytes / restore["verify_s"] / 1e9,
         restore_load_h2d_gb_per_s=ckpt_bytes / restore["load_s"] / 1e9,
         restore_peak_device_gb=restore["peak_device_gb"],
         device_gb_at_start=start_gb, device_gb_after_a=after_a_gb,
         a_losses=a_losses, b_losses=rep_b.stats.losses,
         a_step_ms=[x * 1e3 for x in a_stats.step_times],
         b_step_ms=[x * 1e3 for x in rep_b.stats.step_times],
         a_step_p50_ms=a_summary["p50_step_s"] * 1e3,
         b_step_p50_ms=rep_b.summary["p50_step_s"] * 1e3,
         stragglers_after_save=after_save, touched_keys=touched_ck.numel(),
         sampled_keys=untouched_ck.numel(), bit_equal=same, launches=ckpt_launches)
    if not all(same.values()):
        raise SystemExit(f"the resumed run differs from the uninterrupted one: {same}")
    if not all(np.isfinite(a_losses + rep_b.stats.losses)):
        raise SystemExit("the checkpoint runs' losses are not finite")
    if after_save:
        raise SystemExit(f"steps after the save flagged as stragglers: {after_save}")
    for kind, io in (("save", save), ("restore", restore)):
        if (io["peak_device_gb"] - start_gb) * 1e9 > 1.5 * master_bytes:
            raise SystemExit(f"the {kind} peaked at {io['peak_device_gb']:.2f} GB on "
                             f"the card: more than one master")
    if any(ckpt_launches[k] != v for k, v in ckpt_want.items()):
        raise SystemExit(f"resumed-run launches {ckpt_launches}, want {ckpt_want}")
    del b, rep_b, a_final
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(CKPT_DIR)

    # a mid-run export under async stages holds every submitted commit: the
    # cached tier of dlrm-cached (its full size; a cache that evicts), the
    # tables handed to the checkpoint callback at steps 2 and 4, sync and
    # async, bit for bit
    exports, evictions = {}, {}
    for on in ("off", "on"):
        esess = Session.from_arch("dlrm-cached", store="cached", async_stages=on,
                                  mode="nestpipe", global_batch=POLICY_BATCH,
                                  n_micro=N_MICRO, cache_rows=POLICY_CACHE_ROWS, seed=0)
        got = exports[on] = {}
        driver = esess.strategy.build_driver(
            esess.fns, resolve_stream(esess.workload, esess.data_seed), esess.workload,
            on_checkpoint=lambda st, n, got=got: got.__setitem__(
                n, (st.table.rows.clone(), st.table.accum.clone())),
            ckpt_every=EXPORT_EVERY)
        driver.run(esess._take_state(), EXPORT_STEPS)
        evictions[on] = driver.store.evictions
        del esess, driver
    export_equal = {n: torch.equal(exports["on"][n][0], exports["off"][n][0])
                    and torch.equal(exports["on"][n][1], exports["off"][n][1])
                    for n in exports["off"]}
    emit("checkpoint_async_export", arch="dlrm-cached", store="cached",
         global_batch=POLICY_BATCH, cache_rows=POLICY_CACHE_ROWS, steps=EXPORT_STEPS,
         every=EXPORT_EVERY, exported_at=sorted(exports["off"]),
         evictions=evictions, bit_equal=export_equal)
    if sorted(exports["off"]) != [2, 4] or sorted(exports["on"]) != [2, 4] \
            or not all(export_equal.values()) or not evictions["off"]:
        raise SystemExit(f"async mid-run exports differ from sync: {export_equal}")
    del exports
    emit("checkpoint_phase", seconds=time.perf_counter() - t_phase)

    # -- 6h. faults at full width: chaos, then a real SIGTERM ----------------
    # (a) each run as in 6a (seed 0, one warm-up step, TIER_STEPS counted)
    # with a fault at every store site, each once in the counted run (every
    # train() builds its store and its injector; the warm-up's single step
    # reaches no armed call); the stores' bounded retries replay each stage
    # before its first CUDA work, so the losses, the rows and adagrad state
    # at every touched key and at the sampled keys, the dense params and
    # the optimizer state equal 6a's synchronous run of the tier bit for bit
    t_phase = time.perf_counter()
    start_gb = torch.cuda.memory_allocated() / 1e9
    chaos = []
    for m, fn in tier_patches:
        setattr(HostStore, m, fn)
    try:
        for run, store, kw in CHAOS_RUNS:
            t0 = time.perf_counter()
            tsess, losses, row = tier_run(run, store, capture=False,
                                          fault_inject=CHAOS_SPEC, **kw)
            ref_run = "cached-evicting" if store == "cached" else "host"
            sync_base = chaos_ref[ref_run]
            same = {"losses": losses == sync_base["losses"],
                    **same_final(final_state(tsess.state, keys_t, keys_s),
                                 sync_base["final"])}
            del tsess
            gc.collect()
            torch.cuda.empty_cache()
            rec = {"run": run, "store": store, **kw, "fault_inject": CHAOS_SPEC,
                   "sync_run": ref_run, "equal_to_sync_run": same,
                   **{k: row.get(k) for k in (
                       "faults_injected", "stage_retries", "commit_rollbacks",
                       "stragglers_flagged", "straggler_steps", "step_p50_ms",
                       "step_p99_ms", "step_ms", "samples_per_s", "stage_host_ms_per_step",
                       "h2d_bytes", "d2h_bytes", "wall_s", "launches")},
                   "sync_step_p50_ms": sync_base["row"]["step_p50_ms"],
                   "sync_step_p99_ms": sync_base["row"]["step_p99_ms"],
                   "sync_stragglers_flagged": sync_base["row"].get("stragglers_flagged"),
                   **({"async_twin": CHAOS_ASYNC_TWIN[run],
                       "async_twin_step_p50_ms": exec_p50[CHAOS_ASYNC_TWIN[run]]}
                      if run in CHAOS_ASYNC_TWIN else {}),
                   "seconds": time.perf_counter() - t0}
            chaos.append(rec)
            path_launches[run] = row["launches"]
            if not all(same.values()):
                raise SystemExit(f"the {run} run differs from 6a's {ref_run} run: {same}")
            if row.get("faults_injected") != CHAOS_SITES or row.get("stage_retries", 0) < 3 \
                    or row.get("commit_rollbacks", 0) < 2:
                raise SystemExit(f"the {run} run's faults and retries are off: {rec}")
    finally:
        for m, fn in real_tier.items():
            setattr(HostStore, m, fn)
    emit("chaos", arch=ARCH, global_batch=TRAIN_BATCH, steps=1 + TIER_STEPS,
         touched_keys=keys_t.numel(), sampled_keys=keys_s.numel(), runs=chaos)
    del chaos_ref, keys_s

    # (b) full-width dlrm-ctr on the async host tier, a guard on SIGTERM and
    # no periodic save: the batch source sends a real SIGTERM as it yields
    # batch PREEMPT_SIGNAL_AT (the handler runs on the main thread), the
    # driver stops at the next step boundary and saves on its way out, and a
    # session from seed 1 restores that and trains the steps left; the whole
    # equals an uninterrupted run bit for bit. One master on the card at a
    # time: each session goes before the next is drawn
    t_pre = time.perf_counter()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    CKPT_DIR.mkdir(parents=True)
    pre_kw = dict(mode="nestpipe", global_batch=TRAIN_BATCH, n_micro=N_MICRO,
                  bucket_slack=SLACK, data_seed=0, store="host", async_stages="on")
    u = Session.from_arch(ARCH, seed=0, **pre_kw)
    rep_u = u.train(PREEMPT_STEPS)
    torch.cuda.synchronize()
    touched_pre = window_keys(u, 0, PREEMPT_STEPS)
    sampled_pre = torch.randint(0, u.workload.spec.padded_rows, (SAMPLED_KEYS,), device=dev,
                                generator=torch.Generator(dev).manual_seed(PREEMPT_STEPS))
    u_final = final_state(u.state, touched_pre, sampled_pre)
    u_losses, u_p50 = rep_u.stats.losses, rep_u.summary["p50_step_s"]
    del u, rep_u
    gc.collect()
    torch.cuda.empty_cache()

    handler_before = signal.getsignal(signal.SIGTERM)
    a = Session.from_arch(ARCH, seed=0, ckpt_dir=str(CKPT_DIR),
                          preemption_signals=(signal.SIGTERM,), **pre_kw)
    master_bytes = a.state.table.rows.numel() * 4
    need = sum(t.numel() * t.element_size() for _, t in flatten_state(a.state))
    free = shutil.disk_usage(CKPT_DIR).free
    if free < 1.05 * need:
        raise SystemExit(f"{CKPT_DIR} has {free} bytes free; one checkpoint and "
                         f"5% need {1.05 * need:.0f}")
    if signal.getsignal(signal.SIGTERM) != a.guard._handler:
        raise SystemExit("the session's guard is not SIGTERM's handler")
    real_stream = session_mod.resolve_stream
    sent = []

    def signalling_stream(*a_, **kw):
        def batches():
            for i, batch in enumerate(real_stream(*a_, **kw)):
                if i == PREEMPT_SIGNAL_AT:
                    sent.append(threading.current_thread().name)
                    os.kill(os.getpid(), signal.SIGTERM)
                yield batch
        return batches()

    ckpt_io.clear()
    session_mod.resolve_stream = signalling_stream
    session_mod.save_checkpoint = timed_io("save", real_io["save_checkpoint"])
    reset_counts()
    try:
        rep_a = a.train(PREEMPT_STEPS)
        torch.cuda.synchronize()
    finally:
        session_mod.resolve_stream = real_stream
        session_mod.save_checkpoint = real_io["save_checkpoint"]
        a.guard.restore()
    pre_launches = counts()
    handler_after = signal.getsignal(signal.SIGTERM)
    at = rep_a.stats.preempted_at
    a_losses, a_p50 = rep_a.stats.losses, rep_a.summary["p50_step_s"]
    a_stragglers = rep_a.summary["stragglers_flagged"]
    if handler_after is not handler_before:
        raise SystemExit(f"SIGTERM's handler is {handler_after}, not {handler_before}")
    if at is None or not 1 <= at < PREEMPT_STEPS or len(a_losses) != at \
            or sorted(os.listdir(CKPT_DIR)) != [f"step_{at:08d}"]:
        raise SystemExit(f"the SIGTERM ({sent}) gave preempted_at {at}, "
                         f"{len(a_losses)} steps, {os.listdir(CKPT_DIR)}")
    ckpt_bytes = sum(f.stat().st_size for f in (CKPT_DIR / f"step_{at:08d}").iterdir())
    del a, rep_a  # every reference to A's master
    gc.collect()
    torch.cuda.empty_cache()

    b = Session.from_arch(ARCH, seed=1, ckpt_dir=str(CKPT_DIR), **pre_kw)
    session_mod.restore_latest_verifiable = timed_io(
        "restore", real_io["restore_latest_verifiable"])
    try:
        restored_at = b.restore_if_available()
    finally:
        session_mod.restore_latest_verifiable = real_io["restore_latest_verifiable"]
    if restored_at != at:
        raise SystemExit(f"restore_if_available gave {restored_at}, not {at}")
    reset_counts()
    rep_b = b.train(PREEMPT_STEPS - at)
    torch.cuda.synchronize()
    pre_launches = {k: v + counts()[k] for k, v in pre_launches.items()}
    path_launches["preempt-resume"] = pre_launches
    # the two runs launch what one uninterrupted host-tier run does (no
    # device scatter: the host tier writes its master back on the host)
    pre_want = {"embedding_gather": 3 * N_MICRO * PREEMPT_STEPS,
                "segment_rowsum": (N_MICRO + 1) * PREEMPT_STEPS,
                "buffer_sync": PREEMPT_STEPS - 1, "embedding_scatter": 0}
    same = {"losses": a_losses + rep_b.stats.losses == u_losses,
            **same_final(final_state(b.state, touched_pre, sampled_pre), u_final)}
    save, restore = ckpt_io["save"], ckpt_io["restore"]
    emit("preemption", arch=ARCH, store="host", async_stages="on", global_batch=TRAIN_BATCH,
         steps=PREEMPT_STEPS, signal="SIGTERM", signal_at_batch=PREEMPT_SIGNAL_AT,
         signal_sent_from=sent, preempted_at=at, restored_at=restored_at,
         handler_restored=handler_after is handler_before, free_bytes=free,
         checkpoint_bytes=ckpt_bytes, checkpoint_gb=ckpt_bytes / 1e9,
         master_gb=master_bytes / 1e9, save_s=save["seconds"],
         save_d2h_s=save.get("d2h_s", 0.0), save_write_crc_s=save.get("write_s", 0.0),
         save_gb_per_s=ckpt_bytes / save["seconds"] / 1e9,
         save_peak_device_gb=save["peak_device_gb"], restore_s=restore["seconds"],
         restore_verify_s=restore["verify_s"], restore_load_h2d_s=restore["load_s"],
         restore_gb_per_s=ckpt_bytes / restore["seconds"] / 1e9,
         restore_peak_device_gb=restore["peak_device_gb"], device_gb_at_start=start_gb,
         uninterrupted_losses=u_losses, a_losses=a_losses, b_losses=rep_b.stats.losses,
         uninterrupted_step_p50_ms=u_p50 * 1e3, a_step_p50_ms=a_p50 * 1e3,
         b_step_p50_ms=rep_b.summary["p50_step_s"] * 1e3,
         a_stragglers_flagged=a_stragglers, touched_keys=touched_pre.numel(),
         sampled_keys=sampled_pre.numel(), bit_equal=same, launches=pre_launches,
         seconds=time.perf_counter() - t_pre)
    if not all(same.values()):
        raise SystemExit(f"the resumed run differs from the uninterrupted one: {same}")
    for kind, io in (("save", save), ("restore", restore)):
        if (io["peak_device_gb"] - start_gb) * 1e9 > 1.5 * master_bytes:
            raise SystemExit(f"the {kind} peaked at {io['peak_device_gb']:.2f} GB on "
                             f"the card: more than one master")
    if any(pre_launches[k] != v for k, v in pre_want.items()):
        raise SystemExit(f"preempted and resumed launches {pre_launches}, want {pre_want}")
    del b, rep_b, u_final
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(CKPT_DIR)
    emit("faults_phase", seconds=time.perf_counter() - t_phase)

    # -- 7. consistency at the reduced size ---------------------------------
    kw = dict(reduced=True, global_batch=32, n_micro=N_MICRO, seed=1)
    base = Session.from_arch(ARCH, **kw)
    init = clone_state(base.state)
    finals = {}
    for mode in ("nestpipe", "serial", "async"):
        run = Session.from_arch(ARCH, mode=mode, **kw)
        run.state = clone_state(init)
        finals[mode] = run.train(CONSISTENCY_STEPS)
    rwl = base.workload
    ref_step = build_reference_step(make_dlrm_loss_fn(rwl.cfg), base.optimizer,
                                    constant_lr(base.opt_cfg.lr, dev), N_MICRO)
    transform = make_cluster_transform(N_MICRO, rwl.npcfg.clustering)
    stream = resolve_stream(rwl, base.seed)
    batches = []
    for _ in range(CONSISTENCY_STEPS):
        b = transform(next(stream))
        b.pop("raw_keys")
        batches.append(stage_to_device(b, dev))

    def reference_run(step_fn, start, batches):
        state = clone_state(start)
        with torch.no_grad():
            for b in batches:
                state, _ = step_fn(state, b)
        return state

    ref_state = reference_run(ref_step, init, batches)
    ref_twice = same_bits(ref_state, reference_run(ref_step, init, batches))

    def gap(a, b):
        parts = [a.table.rows - b.table.rows, a.table.accum - b.table.accum]
        parts += [a.dense[k] - b.dense[k] for k in a.dense]
        return max(float(x.abs().max()) for x in parts)

    gaps = {mode: gap(r.state, ref_state) for mode, r in finals.items()}
    gaps["nestpipe_vs_serial"] = gap(finals["nestpipe"].state, finals["serial"].state)
    emit("consistency", arch=ARCH + " (reduced)", steps=CONSISTENCY_STEPS,
         max_abs_diff_to_reference=gaps,
         reference_same_bits_twice=ref_twice,
         nestpipe_equals_reference_bit_for_bit=same_bits(finals["nestpipe"].state, ref_state),
         longest_key_run=longest_key_run(batches), segment_rowsum_chunk=sr.CHUNK,
         losses={m: r.stats.losses for m, r in finals.items()})
    if not ref_twice:
        raise SystemExit("the reference trainer gave other bits on a second run")
    if max(gaps["nestpipe"], gaps["serial"], gaps["nestpipe_vs_serial"]) > 1e-5:
        raise SystemExit(f"nestpipe/serial differ from the reference: {gaps}")
    if gaps["async"] <= 1e-6:
        raise SystemExit(f"async did not diverge from the reference: {gaps}")

    del base, init, finals, ref_state, stream, batches
    gc.collect()
    torch.cuda.empty_cache()

    # -- 8. HSTU attention kernels against their plain versions -----------
    hworst = {"hstu_attention_fwd": 0.0, "hstu_attention_bwd": 0.0}

    def check_hstu(label, q, k, v, do, causal=True, chunk=None, backward=True):
        """Kernel forward (and backward) against the plain versions, within
        HSTU_RTOL of each output's sum of magnitudes + HSTU_ATOL, and the
        same bits on a second run; compared ``chunk`` batch rows at a
        time."""
        out = ha.hstu_attention_fwd(q, k, v, causal)
        grads = ha.hstu_attention_bwd(q, k, v, do, causal) if backward else ()
        if not (torch.equal(out, ha.hstu_attention_fwd(q, k, v, causal)) and all(
                torch.equal(a, b) for a, b in
                zip(grads, ha.hstu_attention_bwd(q, k, v, do, causal)))):
            raise SystemExit(f"hstu_attention is not deterministic at {label}")
        step = chunk or q.shape[0]
        for b0 in range(0, q.shape[0], step):
            sl = slice(b0, b0 + step)
            qs, ks, vs, dos = q[sl], k[sl], v[sl], do[sl]
            out_mag, grad_mags = ref.hstu_attention_magnitudes(qs, ks, vs, dos, causal)
            pairs = [("hstu_attention_fwd", out[sl], ref.hstu_attention_ref(qs, ks, vs, causal),
                      out_mag)]
            if backward:
                pairs += [("hstu_attention_bwd", g_[sl], w_, m_) for g_, w_, m_ in zip(
                    grads, ref.hstu_attention_bwd_ref(qs, ks, vs, dos, causal), grad_mags)]
            for kname, got, want, mag in pairs:
                err = (got - want).abs()
                if not bool((err <= HSTU_RTOL * mag + HSTU_ATOL).all()):
                    raise SystemExit(f"{kname} beyond its bound at {label}: "
                                     f"{float(err.max())}")
                hworst[kname] = max(hworst[kname], float(err.max()))
            del pairs, out_mag, grad_mags

    def hstu_inputs(b, t, h, dqk, dv, strided=True):
        if strided:  # the layer's q, k, v: column slices of one tensor
            mixed = torch.empty((b, t, h, 2 * dqk + 2 * dv), device=dev).normal_(generator=g)
            _, v, q, k = torch.split(mixed, [dv, dv, dqk, dqk], dim=-1)
        else:
            q, k = (torch.empty((b, t, h, dqk), device=dev).normal_(generator=g)
                    for _ in range(2))
            v = torch.empty((b, t, h, dv), device=dev).normal_(generator=g)
        return q, k, v, torch.empty((b, t, h, dv), device=dev).normal_(generator=g)

    hedge = []
    for t in (1, 33, 256, 1024):
        for dqk, dv in ((128, 128), (16, 8), (48, 96)):
            for causal in (True, False):
                check_hstu(f"T={t} dqk={dqk} dv={dv} causal={causal}",
                           *hstu_inputs(2, t, 2, dqk, dv), causal=causal)
                hedge.append(f"T={t},dqk={dqk},dv={dv},causal={causal},strided")
        check_hstu(f"T={t} contiguous", *hstu_inputs(2, t, 2, 128, 128, strided=False))
        hedge.append(f"T={t},dqk=dv=128,contiguous")
    # head dims below the MMA's k of 8 (zero-padded), a ragged last tile
    for t in (65, 1024):
        for causal in (True, False):
            check_hstu(f"T={t} dqk=5 dv=3 causal={causal}", *hstu_inputs(2, t, 2, 5, 3),
                       causal=causal)
            hedge.append(f"T={t},dqk=5,dv=3,causal={causal},strided")
    torch.cuda.synchronize()
    emit("hstu_kernel_edges", cases=hedge, max_abs_err=dict(hworst),
         tolerance=f"|kernel - plain| <= {HSTU_RTOL} x each output's sum of "
                   f"magnitudes + {HSTU_ATOL}; the same bits on two runs")

    # -- 9. full-width HSTU training -----------------------------------------
    hcfg = HSTU_INDUSTRIAL_ONE_CARD
    harch = ArchSpec("hstu-industrial", "recsys", hcfg,
                     get_arch("hstu-industrial").reduced)
    hwl = assemble_workload(harch, hcfg, device=dev, mode="nestpipe",
                            npcfg=NestPipeConfig(fwp_microbatches=N_MICRO,
                                                 bucket_slack=SLACK),
                            global_batch=HSTU_BATCH)
    hsess = Session.from_workload(hwl, seed=0)
    hdims = hwl.engine.dims(hwl.batch_shapes["keys"][0][1:], N_MICRO)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hrows = hsess.state.table.rows
    torch.cuda.synchronize()
    emit("hstu_init", seconds=round(time.perf_counter() - t0, 3),
         config={k: getattr(hcfg, k) for k in ("d_model", "n_layers", "n_heads",
                                               "seq_len", "compute_dtype")},
         tables={t.name: t.vocab_size for t in hcfg.tables},
         table_rows=hrows.shape[0], dim=hrows.shape[1],
         table_gb=round(hrows.numel() * 4 / 1e9, 3),
         dense_params=sum(p.numel() for p in hsess.state.dense.values()),
         dims={"L": hdims.l_local, "U": hdims.u_max, "C": hdims.cap,
               "K": hdims.buffer_cap, "N": hdims.n_micro},
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    del hrows
    hsess.train(1)  # unchecked warm-up step
    torch.cuda.synchronize()

    # two steps with the first call of each kernel kept: the attention
    # forward and backward (copies with the same strides; every call
    # counted) and, as on the DLRM path, the embedding kernels' calls
    seen = {"fwd": 0, "bwd": 0}
    kept = {}
    real_fwd, real_bwd = ha.hstu_attention_fwd, ha.hstu_attention_bwd

    def strided_copies(*xs):
        """Copies that keep each view's strides: q, k and v are column
        slices of one tensor, whose storage is copied once."""
        storages = {}
        out = []
        for x in xs:
            st = x.untyped_storage()
            if st.data_ptr() not in storages:
                storages[st.data_ptr()] = st.clone()
            out.append(torch.empty(0, dtype=x.dtype, device=x.device).set_(
                storages[st.data_ptr()], x.storage_offset(), x.size(), x.stride()))
        return out

    def fwd_spy(q, k, v, causal=True):
        seen["fwd"] += 1
        if "fwd" not in kept:
            kept["fwd"] = (*strided_copies(q, k, v), causal)
        return real_fwd(q, k, v, causal)

    def bwd_spy(q, k, v, do, causal=True):
        seen["bwd"] += 1
        if "bwd" not in kept:
            kept["bwd"] = (*strided_copies(q, k, v), do.clone(), causal)
        return real_bwd(q, k, v, do, causal)

    ha.hstu_attention_fwd, ha.hstu_attention_bwd = fwd_spy, bwd_spy
    try:
        hcaptured = capture_calls(hsess)
    finally:
        ha.hstu_attention_fwd, ha.hstu_attention_bwd = real_fwd, real_bwd
    n_layers = hcfg.n_layers
    if seen != {"fwd": 2 * 2 * n_layers * N_MICRO, "bwd": 2 * n_layers * N_MICRO}:
        raise SystemExit(f"two HSTU steps made {seen} attention calls")
    # the embedding kernels at this path's shapes (D = 512, K = 393,216 rows,
    # f32 retrieve and buffer rows, bf16 assembly), while the master lives
    hshapes = check_and_time("hstu_train", hcaptured, hsess.state.table)
    del hcaptured
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    hrep = hsess.train(HSTU_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hstu_launches = counts()
    s = hrep.summary
    samples_per_s = HSTU_BATCH * HSTU_STEPS / wall
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit("hstu_train", arch=f"hstu-industrial (vocabularies / {HSTU_ROW_CUT:g})",
         mode="nestpipe",
         global_batch=HSTU_BATCH, n_micro=N_MICRO, bucket_slack=SLACK,
         steps=HSTU_STEPS, losses=hrep.stats.losses, overflow_max=s["overflow_max"],
         samples_per_s=samples_per_s, tokens_per_s=samples_per_s * hcfg.seq_len,
         wall_s=wall, step_ms=[x * 1e3 for x in hrep.stats.step_times],
         step_p50_ms=s["p50_step_s"] * 1e3, step_p99_ms=s["p99_step_s"] * 1e3,
         mean_input_wait_ms=s["mean_input_wait_s"] * 1e3,
         stage_host_ms={k: s[k] for k in ("plan_ms", "retrieve_ms", "commit_ms")},
         launches=hstu_launches, max_memory_allocated_gb=peak_gb,
         device_memory_gb=torch.cuda.get_device_properties(0).total_memory / 1e9)
    if not all(np.isfinite(hrep.stats.losses)) or len(hrep.stats.losses) != HSTU_STEPS:
        raise SystemExit(f"HSTU losses are not {HSTU_STEPS} finite values")
    if s["overflow_max"] != 0:
        raise SystemExit(f"HSTU routing overflowed: {s['overflow_max']}")
    if peak_gb * 1e9 >= torch.cuda.get_device_properties(0).total_memory:
        raise SystemExit(f"HSTU peak memory {peak_gb} GB does not fit the card")
    hstu_want = {"embedding_gather": (1 + 3 * N_MICRO) * HSTU_STEPS,
                 "segment_rowsum": (N_MICRO + 1) * HSTU_STEPS,
                 "buffer_sync": HSTU_STEPS - 1, "embedding_scatter": HSTU_STEPS,
                 # each layer's forward runs again in the backward (per-layer remat)
                 "hstu_attention_fwd": 2 * n_layers * N_MICRO * HSTU_STEPS,
                 "hstu_attention_bwd": n_layers * N_MICRO * HSTU_STEPS,
                 "flash_attention_wgmma": 0, "flash_attention_simple": 0,
                 "flash_attention_tf32x3": 0, "flash_attention_bwd_tf32x3": 0,
                 "flash_attention_bwd_simple": 0, "flash_attention_bwd_wgmma": 0}
    if hstu_launches != hstu_want:
        raise SystemExit(f"HSTU launches {hstu_launches} != {hstu_want}")
    if hstu_launches["hstu_attention_fwd"] != HSTU_FWD_CALLS_PER_STEP * HSTU_STEPS:
        raise SystemExit(f"{hstu_launches['hstu_attention_fwd']} forward calls in "
                         f"{HSTU_STEPS} steps, not {HSTU_FWD_CALLS_PER_STEP} a step")

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            hsess.train(2)
            torch.cuda.synchronize()
            span = time.perf_counter() - t0
        emit_profile(prof, "hstu_train_profile", span, steps=2)
        del prof
    del hsess, hwl, hrep
    gc.collect()
    torch.cuda.empty_cache()

    # the captured main-path calls, on the card alone now: checked and timed
    peak_fp32 = peak_flops_fp32(torch, name)
    hrows_out = {}
    q, k, v, causal = kept["fwd"]
    check_hstu("main-path forward call", q, k, v, torch.zeros_like(v), causal, chunk=16,
               backward=False)
    fwd_ops, _ = hstu_work(q, v.shape[-1], causal)
    fwd_bytes = 4 * (q.numel() + k.numel() + 2 * v.numel())  # q, k, v read; out written
    hrows_out["hstu_attention_fwd"] = {
        "ms": time_ms(torch, lambda: ha.hstu_attention_fwd(q, k, v, causal), flush),
        "plain_ms": time_ms(torch, lambda: ref.hstu_attention_ref(q, k, v, causal), flush),
        "operations": fwd_ops, "bytes": fwd_bytes,
        "tf32_mma_operations": hstu_fwd_mma_ops(q, v.shape[-1], causal)}
    fwd_row = hrows_out["hstu_attention_fwd"]
    fwd_row["tf32_mma_tflops"] = fwd_row["tf32_mma_operations"] / fwd_row["ms"] / 1e9
    fwd_row["tf32_peak_share"] = fwd_row["tf32_mma_tflops"] * 1e12 / tf32_flops(name)
    q, k, v, do, causal = kept["bwd"]
    check_hstu("main-path backward call", q, k, v, do, causal, chunk=16)
    _, bwd_ops = hstu_work(q, v.shape[-1], causal)
    # q, k, v, dO read; dq, dk, dv written
    bwd_bytes = 4 * (2 * (q.numel() + k.numel() + v.numel()) + do.numel())
    hrows_out["hstu_attention_bwd"] = {
        "ms": time_ms(torch, lambda: ha.hstu_attention_bwd(q, k, v, do, causal), flush),
        "plain_ms": time_ms(torch, lambda: ref.hstu_attention_bwd_ref(q, k, v, do, causal),
                            flush),
        "operations": bwd_ops, "bytes": bwd_bytes}
    for kname, row in hrows_out.items():
        row.update(shape=list(q.shape), dv=v.shape[-1], causal=causal,
                   **f32_work_bound(row["operations"], row["bytes"], name, peak, peak_fp32),
                   peak_fp32_flops=peak_fp32, achieved_tflops=row["operations"]
                   / row["ms"] / 1e9, library_ms=None)
        emit("kernel_shape", path="hstu_train", kernel=kname, **row)
    del kept, q, k, v, do, flush
    gc.collect()
    torch.cuda.empty_cache()

    # -- 10. consistency at hstu-reduced -------------------------------------
    def reduced_gaps(sparse_lr=None, adam_eps=None, arch="hstu-industrial"):
        """Per mode, the gap to the reference trainer after
        CONSISTENCY_STEPS steps from one state, at the configuration's own
        step sizes unless ``sparse_lr`` and ``adam_eps`` are given; the
        reduced ``arch`` (HSTU's, FuXi's in phase 11c, or an LM's in 13c
        and 13g: 16 sequences of 32 tokens). An MoE's capacity and
        load-balance term depend on which tokens share a micro-batch, and
        serial cuts its micro-batches unclustered: its reference is then a
        second one, on those micro-batches ("serial_reference")."""
        opt_cfg = OptimizerConfig() if adam_eps is None else OptimizerConfig(eps=adam_eps)
        kw = dict(reduced=True, global_batch=16, n_micro=N_MICRO, seed=1, opt_cfg=opt_cfg)
        runs = {}
        for mode in ("nestpipe", "serial", "async"):
            runs[mode] = Session.from_arch(arch, mode=mode, **kw)
            if sparse_lr is not None:
                runs[mode].workload.engine.sparse_lr = sparse_lr
        first = runs["nestpipe"]
        init = clone_state(first.state)
        finals = {}
        for mode, run in runs.items():
            run.state = clone_state(init)
            finals[mode] = run.train(CONSISTENCY_STEPS)
        rwl = first.workload
        loss_fn = (make_loss_fn(rwl.cfg) if rwl.bundle is None
                   else rwl.bundle.loss_fn(rwl.t_chunk))
        ref_step = build_reference_step(loss_fn, first.optimizer,
                                        constant_lr(first.opt_cfg.lr, dev), N_MICRO,
                                        sparse_lr=rwl.engine.sparse_lr)

        def staged(clustering):
            transform = make_cluster_transform(N_MICRO, clustering)
            stream = resolve_stream(rwl, first.seed)
            return [stage_to_device({k: b[k] for k in rwl.batch_shapes}, dev)
                    for b in (transform(next(stream)) for _ in range(CONSISTENCY_STEPS))]

        batches = staged(rwl.npcfg.clustering)
        ref_state = reference_run(ref_step, init, batches)
        ref_twice = same_bits(ref_state, reference_run(ref_step, init, batches))
        moe = getattr(rwl.cfg, "moe", None) is not None
        serial_ref = reference_run(ref_step, init, staged("none")) if moe else ref_state

        def two(a, b):
            parts = [a.table.rows - b.table.rows] + [a.dense[k] - b.dense[k] for k in a.dense]
            accum = (a.table.accum - b.table.accum).abs() / (1 + b.table.accum.abs())
            return {"rows_dense": max(float(x.abs().max()) for x in parts),
                    "accum_rel": float(accum.max()),
                    "accum_abs": float((a.table.accum - b.table.accum).abs().max())}

        gaps = {mode: two(r.state, serial_ref if mode == "serial" else ref_state)
                for mode, r in finals.items()}
        gaps["nestpipe_vs_serial"] = two(finals["nestpipe"].state, finals["serial"].state)
        return {"serial_reference": "unclustered micro-batches" if moe else "the reference",
"sparse_lr": rwl.engine.sparse_lr, "adam_eps": first.opt_cfg.eps,
                "max_diff_to_reference": gaps, "reference_same_bits_twice": ref_twice,
                "nestpipe_equals_reference_bit_for_bit": same_bits(finals["nestpipe"].state,
                                                                   ref_state),
                "longest_key_run": longest_key_run(batches), "segment_rowsum_chunk": sr.CHUNK,
                "losses": {m: r.stats.losses for m, r in finals.items()}}

    hstu_runs = {"default_step_sizes": reduced_gaps(),
                 "small_step_sizes": reduced_gaps(**HSTU_SMALL_STEPS)}
    emit("hstu_consistency", arch="hstu-industrial (reduced)", steps=CONSISTENCY_STEPS,
         **hstu_runs, bounds="rows and dense within 1e-5, accum within 1e-4 of "
         "1 + accum; async more than 1e-6 from the reference")
    for label, run in hstu_runs.items():
        if not run["reference_same_bits_twice"]:
            raise SystemExit(f"the HSTU reference gave other bits on a second run at the {label}")
        hgaps = run["max_diff_to_reference"]
        for key in ("nestpipe", "serial", "nestpipe_vs_serial"):
            if hgaps[key]["rows_dense"] > 1e-5 or hgaps[key]["accum_rel"] > 1e-4:
                raise SystemExit(f"HSTU {key} differs from the reference at the "
                                 f"{label}: {hgaps}")
        if hgaps["async"]["rows_dense"] <= 1e-6:
            raise SystemExit(f"HSTU async did not diverge at the {label}: {hgaps}")

    # -- 11. release --------------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    emit("release", memory_allocated_gb=torch.cuda.memory_allocated() / 1e9,
         memory_reserved_gb=torch.cuda.memory_reserved() / 1e9)

    # -- 11a. flash_attention backward against its plain version ---------------
    t_phase = time.perf_counter()
    bworst, bshare = {}, {}  # the largest |kernel - plain| and |kernel - plain| / bound
    bwd_kernels = ("flash_attention_bwd_tf32x3", "flash_attention_bwd_wgmma",
                   "flash_attention_bwd_simple")

    def run_bwd(label, kind, q, k, v, out, do, lse, causal):
        """The backward kernel ``kind`` (``fa.flash_attention_bwd`` where
        ``fa.bwd_variant`` picks it, else ``fa.flash_attention_bwd_simple``)
        twice: the same bits, and only its counter moved, by 2."""
        fn = (fa.flash_attention_bwd if fa.bwd_variant(q, k, v) == kind
              else fa.flash_attention_bwd_simple)
        before = counts()
        got = fn(q, k, v, out, do, lse, causal)
        if not all(torch.equal(a, b) for a, b in zip(got, fn(q, k, v, out, do, lse, causal))):
            raise SystemExit(f"flash_attention_bwd_{kind} is not deterministic at {label}")
        moved = {kn: counts()[kn] - before[kn] for kn in bwd_kernels}
        if moved != {kn: 2 * (kn == f"flash_attention_bwd_{kind}") for kn in bwd_kernels}:
            raise SystemExit(f"{label}: flash_attention_bwd_{kind} run, but launches moved "
                             f"by {moved}")
        return got

    def check_flash_bwd(label, q, k, v, causal, chunk=None, given=None):
        """The forward's output and lse through ``fa.flash_attention_lse``
        (the tf32x3 kernel for f32 at hd <= 128, the wgmma kernel for bf16
        at its head dims, else the general one; its counter must move) or
        ``given`` (o, do, lse), then the backward
        kernel ``fa.bwd_variant`` picks on a random output gradient and,
        where that is the tf32x3 or the wgmma kernel, the general one too,
        each against the plain versions, ``chunk`` batch rows at a time:
        the lse within ref.flash_attention_lse_bound, dq, dk and dv within
        ref.flash_attention_bwd_bound (its bf16 form for the wgmma
        kernel); the same bits on a second run of each kernel. Returns the
        largest errors by backward kernel."""
        if given is None:
            fwd = f"flash_attention_{fa.lse_variant(q, k, v)}"
            fwd_before = counts()[fwd]
            out, lse = fa.flash_attention_lse(q, k, v, causal)
            do = torch.empty(out.shape, device=dev).normal_(generator=g).to(q.dtype)
            out2, lse2 = fa.flash_attention_lse(q, k, v, causal)
            if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
                raise SystemExit(f"flash_attention forward is not deterministic at {label}")
            if counts()[fwd] != fwd_before + 2:
                raise SystemExit(f"{label}: the forward did not run {fwd}")
            del out2, lse2
        else:
            out, do, lse = given
        picked = fa.bwd_variant(q, k, v)
        kinds = (picked, "simple") if picked != "simple" else ("simple",)
        grads = {kind: run_bwd(label, kind, q, k, v, out, do, lse, causal) for kind in kinds}
        dname = str(q.dtype).removeprefix("torch.")
        errs = {kind: {} for kind in kinds}
        lerr_max = 0.0
        step = chunk or q.shape[0]
        for b0 in range(0, q.shape[0], step):
            sl = slice(b0, b0 + step)
            qs, ks, vs, os_, dos, ls = q[sl], k[sl], v[sl], out[sl], do[sl], lse[sl]
            if given is None:
                lse_want = ref.flash_attention_lse_ref(qs, ks, causal)
                lerr = (ls - lse_want).abs()
                if not bool((lerr <= ref.flash_attention_lse_bound(qs, ks, lse_want,
                                                                   causal)).all()):
                    raise SystemExit(f"the forward's lse beyond its bound at {label}: "
                                     f"{float(lerr.max())}")
                lerr_max = max(lerr_max, float(lerr.max()))
            want = ref.flash_attention_bwd_ref(qs, ks, vs, os_, dos, ls, causal)
            bounds = {products: ref.flash_attention_bwd_bound(
                qs, ks, vs, os_, dos, ls, want, causal, products=products)
                for products in (("f32", "bf16") if "wgmma" in grads else ("f32",))}
            for kind, got in grads.items():
                for name, got_, w, bd in zip(("dq", "dk", "dv"), got, want,
                                             bounds["bf16" if kind == "wgmma" else "f32"]):
                    err = (got_[sl].float() - w.float()).abs()
                    if not bool((err <= bd).all()):
                        raise SystemExit(f"flash_attention_bwd_{kind} {name} beyond its "
                                         f"bound at {label}: {float(err.max())}")
                    errs[kind][name] = max(errs[kind].get(name, 0.0), float(err.max()))
                    key = f"flash_attention_bwd_{kind} {dname}"
                    bshare[key] = max(bshare.get(key, 0.0), float((err / bd).max()))
            del want, bounds
        if given is None:
            key = f"lse of flash_attention_{fa.lse_variant(q, k, v)} {dname}"
            bworst[key] = max(bworst.get(key, 0.0), lerr_max)
        for kind, e in errs.items():
            key = f"flash_attention_bwd_{kind} {dname}"
            bworst[key] = max([bworst.get(key, 0.0), *e.values()])
        return errs

    def flash_inputs(b, tq, tk, h, kv, hd, dtype):
        return [torch.empty((b, t, n, hd), device=dev).normal_(generator=g).to(dtype)
                for t, n in ((tq, h), (tk, kv), (tk, kv))]

    bedge = []
    for dtype, dims in ((torch.float32, (16, 64, 80, 128, 160)),
                        (torch.bfloat16, (16, 64, 80, 128, 160))):
        dname = str(dtype).removeprefix("torch.")
        for t in (1, 33, 64, 257, 512):
            for hd in dims:
                for kv in (4, 1):  # H/KV 1 and 4
                    for causal in (True, False):
                        check_flash_bwd(f"T={t} hd={hd} H/KV={4 // kv} causal={causal} "
                                        f"{dname}", *flash_inputs(1, t, t, 4, kv, hd, dtype),
                                        causal)
        bedge.append(f"{dname} T in {{1,33,64,257,512}} hd in {dims} H/KV in {{1,4}} "
                     "causal and not" + (" (tf32x3 at hd <= 128, and the general kernel too)"
                                         if dtype == torch.float32 else
                                         " (wgmma at hd 64, 80, 128, 160, and the general "
                                         "kernel too; general at 16)"))
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for causal in (True, False):
            check_flash_bwd(f"Tq=33 Tk=100 causal={causal} {dname}",
                            *flash_inputs(2, 33, 100, 4, 1, 64, dtype), causal)
            check_flash_bwd(f"Tq=100 Tk=33 causal={causal} {dname}",
                            *flash_inputs(2, 100, 33, 4, 1, 64, dtype), causal)
        bedge.append(f"{dname} Tq=33 Tk=100 and Tq=100 Tk=33, hd=64 H/KV=4 causal and not "
                     "(both kernels)")
        # q, k, v column slices of one wider tensor, off 16-byte alignment
        # (the wgmma kernel reads contiguous copies)
        wide = torch.empty((2, 100, 4, 3 * 64 + 3), device=dev).normal_(generator=g).to(dtype)
        check_flash_bwd(f"strided {dname}", wide[..., 3:67], wide[..., 67:131],
                        wide[..., 131:195], True)
        bedge.append(f"{dname} strided q, k, v (T=100, hd=64, 3 elements in; both kernels)")
        del wide
    # bf16 values of one sign (q and k times 1, 2, 3: scores of 5 to 50,
    # alike from key to key) at stablelm-3b's head dim
    for mul in (1, 2, 3):
        q, k, v = flash_inputs(1, 512, 512, 4, 4, 80, torch.float32)
        q, k, v = (mul * q.abs()).to(torch.bfloat16), (mul * k.abs()).to(torch.bfloat16), \
            v.to(torch.bfloat16)
        check_flash_bwd(f"same-sign bf16 x {mul}", q, k, v, True)
    bedge.append("bfloat16 1 x 512 x 4 x 80 causal, q and k of one sign times 1, 2, 3 "
                 "(both kernels)")
    del q, k, v
    # the layout never picks the kernel: the same values as contiguous
    # tensors, 3 elements off 16-byte alignment (element loads) and with
    # heads outside positions (cp.async at other strides) give the tf32x3
    # backward's same bits
    layouts = {
        "off_alignment": lambda x: torch.zeros(x.numel() + 3, dtype=x.dtype, device=dev)[
            3:].view(x.shape).copy_(x),
        "heads_outside": lambda x: x.transpose(1, 2).contiguous().transpose(1, 2)}
    for dtype, hd, kind in ((torch.float32, 64, "tf32x3"), (torch.bfloat16, 80, "wgmma")):
        base = flash_inputs(2, 100, 100, 4, 1, hd, dtype)
        base_do = torch.empty((2, 100, 4, hd), device=dev).normal_(generator=g).to(dtype)
        for causal in (True, False):
            out, lse = fa.flash_attention_lse(*base, causal)
            want_bits = fa.flash_attention_bwd(*base, out, base_do, lse, causal)
            for lname, layout in layouts.items():
                views = [layout(x) for x in (*base, out, base_do)]
                before = counts()[f"flash_attention_bwd_{kind}"]
                got = fa.flash_attention_bwd(*views, lse, causal)
                if counts()[f"flash_attention_bwd_{kind}"] != before + 1:
                    raise SystemExit(f"the {lname} layout did not run the {kind} backward")
                if not all(torch.equal(a, b) for a, b in zip(got, want_bits)):
                    raise SystemExit(f"the {lname} layout changed the {kind} backward's "
                                     f"bits (causal={causal})")
                bedge.append(f"{str(dtype).removeprefix('torch.')} T=100 hd={hd} {lname} "
                             f"(causal={causal}): the contiguous layout's bits through the "
                             f"{kind} backward")
    del base, base_do, out, lse, want_bits, got, views

    # values of one sign at FuXi's shape (v and do shifted by 2; q and k
    # times 1, 2 and 3: scores of std ~1, 4 and 9), where the MMA sums of
    # dv run long in one direction, three draws each, through both backward
    # kernels on the tf32x3 forward's output and lse; each draw's share of
    # ref.flash_attention_bwd_bound against an f64 evaluation of the same
    # formulas on the same inputs and against the plain f32 version
    # printed. The first draw at x 1 goes through check_flash_bwd. The
    # tf32x3 backward is held within the bound of the f64 evaluation at
    # every scale where the general (f32 FFMA) kernel holds it in all three
    # draws; the rest is printed
    def exact_bwd(q, k, v, o, do, lse):
        """dq, dk, dv of causal attention of q (B, T, H, hd) over k, v (B, T,
        KV, hd) in f64, from the forward's o and lse; query head h reads kv
        head h // (H / KV), and each kv head's dk, dv sum over its group."""
        group = q.shape[2] // k.shape[2]
        qd, od, dod = (x.double() for x in (q, o, do))
        kd, vd = (x.double().repeat_interleave(group, dim=2) for x in (k, v))
        scale = q.shape[-1] ** -0.5
        b, t, h, hd = q.shape
        keep = torch.ones((t, t), dtype=torch.bool, device=dev).tril()
        s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
        p = torch.exp(s - lse.double()[..., None]).masked_fill(~keep, 0.0)
        delta = (dod * od).sum(-1).transpose(1, 2)
        ds = p * (torch.einsum("bqhd,bkhd->bhqk", dod, vd) - delta[..., None])
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, qd) * scale
        dv = torch.einsum("bhqk,bqhd->bkhd", p, dod)
        return (torch.einsum("bhqk,bkhd->bqhd", ds, kd) * scale,
                dk.reshape(b, t, h // group, group, hd).sum(3),
                dv.reshape(b, t, h // group, group, hd).sum(3))

    bwd_same_sign = []
    for scale in (1, 2, 3):
        for draw in range(3):
            q, k, v = flash_inputs(64, 512, 512, 8, 8, 64, torch.float32)
            q, k, v = scale * q, scale * k, v + 2
            out, lse = fa.flash_attention_lse(q, k, v, True)
            do = torch.empty(out.shape, device=dev).normal_(generator=g) + 2
            if scale == 1 and draw == 0:
                check_flash_bwd("same-sign f32 at FuXi's shape", q, k, v, True, chunk=8,
                                given=(out, do, lse))
            grads = {kind: run_bwd("same-sign", kind, q, k, v, out, do, lse, True)
                     for kind in ("tf32x3", "simple")}
            shares = {kind: {"plain": 0.0, "f64": 0.0} for kind in grads}
            for b0 in range(0, q.shape[0], 8):
                sl = slice(b0, b0 + 8)
                inputs = (q[sl], k[sl], v[sl], out[sl], do[sl], lse[sl])
                want = ref.flash_attention_bwd_ref(*inputs, True)
                bounds = ref.flash_attention_bwd_bound(*inputs, want, True)
                exact = exact_bwd(*inputs)
                for kind, got in grads.items():
                    for ref_, w in (("plain", want), ("f64", exact)):
                        shares[kind][ref_] = max([shares[kind][ref_]] + [
                            float(((g_[sl].double() - w_.double()).abs() / bd).max())
                            for g_, w_, bd in zip(got, w, bounds)])
                del want, bounds, exact
            for kind, sh in shares.items():
                bwd_same_sign.append({"kernel": f"flash_attention_bwd_{kind}", "scale": scale,
                                      "draw": draw, "share_of_bound_vs_plain": sh["plain"],
                                      "share_of_bound_vs_f64": sh["f64"]})
            del q, k, v, out, lse, do, grads
    for case in bwd_same_sign:
        case["held"] = case["kernel"] == "flash_attention_bwd_tf32x3" and all(
            c["share_of_bound_vs_f64"] <= 1 for c in bwd_same_sign
            if c["kernel"] == "flash_attention_bwd_simple" and c["scale"] == case["scale"])
    bedge.append("float32 64 x 512 x 8 x 64 causal, q and k x 1, 2, 3 (3 draws each), v and "
                 "do + 2: both kernels' shares of the bound printed, the tf32x3 backward "
                 "within the bound of an f64 evaluation wherever the general kernel is "
                 "(x 1, draw 0: both within it of the plain version)")
    emit("flash_bwd_same_sign", shape=[64, 512, 8, 64], causal=True, cases=bwd_same_sign,
         headroom={kn: {str(sc): {ref_: 1 - max(c[f"share_of_bound_vs_{ref_}"]
                                                for c in bwd_same_sign
                                                if c["kernel"] == kn and c["scale"] == sc)
                                  for ref_ in ("plain", "f64")}
                        for sc in (1, 2, 3)}
                   for kn in ("flash_attention_bwd_tf32x3", "flash_attention_bwd_simple")})
    for case in bwd_same_sign:
        if case["held"] and case["share_of_bound_vs_f64"] > 1:
            raise SystemExit(f"{case['kernel']} beyond its bound of the f64 evaluation on "
                             f"values of one sign: {case}")
    # bf16 values of one sign at pixtral's head dim (q and k of one sign
    # times 1, 2 and 3; v and do plus 2), 8 query heads over 2, through the
    # wgmma backward (its dk/dv kernel 32 queries a tile) and the general
    # one, each within its bound of the plain version (check_flash_bwd:
    # the bf16 form for the wgmma kernel, the f32 form for the general);
    # each kernel's share of its bound against the plain version and an f64
    # evaluation of the same formulas on the same inputs printed
    bf16_same_sign = []
    for mul in (1, 2, 3):
        q, k, v = flash_inputs(1, 512, 512, 8, 2, 160, torch.float32)
        q, k, v = ((mul * q.abs()).to(torch.bfloat16), (mul * k.abs()).to(torch.bfloat16),
                   (v + 2).to(torch.bfloat16))
        out, lse = fa.flash_attention_lse(q, k, v, True)
        do = (torch.empty(out.shape, device=dev).normal_(generator=g) + 2).to(torch.bfloat16)
        check_flash_bwd(f"same-sign bf16 hd 160 x {mul}", q, k, v, True, given=(out, do, lse))
        want = ref.flash_attention_bwd_ref(q, k, v, out, do, lse, True)
        exact = exact_bwd(q, k, v, out, do, lse)
        for kind, products in (("wgmma", "bf16"), ("simple", "f32")):
            got = run_bwd("same-sign bf16 hd 160", kind, q, k, v, out, do, lse, True)
            bounds = ref.flash_attention_bwd_bound(q, k, v, out, do, lse, want, True,
                                                   products=products)
            bf16_same_sign.append({
                "kernel": f"flash_attention_bwd_{kind}", "bound": products, "scale": mul,
                **{f"share_of_bound_vs_{ref_}": max(
                    float(((g_.double() - w_.double()).abs() / bd).max())
                    for g_, w_, bd in zip(got, w, bounds))
                   for ref_, w in (("plain", want), ("f64", exact))}})
        del q, k, v, out, lse, do, want, exact, got, bounds
    bedge.append("bfloat16 1 x 512 x 8 x 160 over 2 kv heads causal, q and k of one sign x 1, "
                 "2, 3, v and do + 2 (both kernels; shares printed)")
    emit("flash_bwd_same_sign_bf16", shape=[1, 512, 8, 160], kv_heads=2, causal=True,
         cases=bf16_same_sign)
    torch.cuda.synchronize()
    emit("flash_bwd_edges", cases=bedge, max_abs_err=bworst, max_share_of_bound=bshare,
         forward="the tf32x3 kernel's output and lse for f32 (hd <= 128), the wgmma "
                 "kernel's for bf16 at hd 64, 80, 128 and 160, the general kernel's for bf16 "
                 "at hd 16 and f32 at hd 160",
         seconds=time.perf_counter() - t_phase,
         tolerance="dq, dk, dv: |kernel - plain| <= 1e-5 M + 1e-7 (+ one bf16 ulp of the "
                   "plain gradient in bf16), M each gradient's sum of magnitudes "
                   "(ref.flash_attention_bwd_bound); the wgmma backward: + 2**-8 of the "
                   "sums of the terms' own magnitudes (products='bf16': P and dS rounded "
                   "to bf16 as operands); the general kernel on bf16 inputs: the f32 form; "
                   "lse: ref.flash_attention_lse_bound; the same bits on two runs")

    # -- 11b. main path: full-size fuxi-kuairand training --------------------------
    t_phase = time.perf_counter()
    fsess = Session.from_arch(FUXI_ARCH, mode="nestpipe", global_batch=FUXI_BATCH,
                              n_micro=N_MICRO, bucket_slack=SLACK, seed=0)
    fwl, fcfg = fsess.workload, fsess.workload.cfg
    fdims = fwl.engine.dims(fwl.batch_shapes["keys"][0][1:], N_MICRO)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ftable = fsess.state.table.rows
    torch.cuda.synchronize()
    emit("fuxi_init", seconds=round(time.perf_counter() - t0, 3),
         config={k: getattr(fcfg, k) for k in ("d_model", "n_layers", "n_heads", "d_ff",
                                               "seq_len", "compute_dtype")},
         tables={t.name: t.vocab_size for t in fcfg.tables},
         table_rows=ftable.shape[0], dim=ftable.shape[1],
         table_gb=round(ftable.numel() * 4 / 1e9, 3),
         dense_params=sum(p_.numel() for p_ in fsess.state.dense.values()),
         dims={"L": fdims.l_local, "U": fdims.u_max, "C": fdims.cap,
               "K": fdims.buffer_cap, "N": fdims.n_micro},
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    if tuple(ftable.shape) != (32_027_000, 256) or ftable.device.type != "cuda":
        raise SystemExit(f"the fuxi-kuairand master is {tuple(ftable.shape)} on "
                         f"{ftable.device}, not the full 32,027,000 x 256 on the card")
    del ftable
    fsess.train(1)  # unchecked warm-up step
    torch.cuda.synchronize()

    # two steps with the first forward (with its lse) and backward call kept
    # (every call counted) and, as on the DLRM path, the embedding kernels' calls
    seen = {"fwd": 0, "bwd": 0}
    fkept = {}
    real_lse, real_fbwd = fa.flash_attention_lse, fa.flash_attention_bwd

    def lse_spy(q, k, v, causal=True):
        seen["fwd"] += 1
        if "fwd" not in fkept:
            fkept["fwd"] = (q.clone(), k.clone(), v.clone(), causal)
        return real_lse(q, k, v, causal)

    def fbwd_spy(q, k, v, o, do, lse, causal=True):
        seen["bwd"] += 1
        if "bwd" not in fkept:
            fkept["bwd"] = (*(x.clone() for x in (q, k, v, o, do, lse)), causal)
        return real_fbwd(q, k, v, o, do, lse, causal)

    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)  # evicts the L2 (time_ms)
    fa.flash_attention_lse, fa.flash_attention_bwd = lse_spy, fbwd_spy
    try:
        fcaptured = capture_calls(fsess)
    finally:
        fa.flash_attention_lse, fa.flash_attention_bwd = real_lse, real_fbwd
    if seen != {"fwd": 2 * FUXI_FWD_CALLS_PER_STEP, "bwd": 2 * FUXI_BWD_CALLS_PER_STEP}:
        raise SystemExit(f"two FuXi steps made {seen} attention calls")
    # the embedding kernels at this path's shapes (D = 256, f32 retrieve and
    # buffer rows, bf16 assembly), while the master lives
    fshapes = check_and_time("fuxi_train", fcaptured, fsess.state.table)
    del fcaptured
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    frep = fsess.train(FUXI_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fuxi_launches = counts()
    s = frep.summary
    samples_per_s = FUXI_BATCH * FUXI_STEPS / wall
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit("fuxi_train", arch=FUXI_ARCH, mode="nestpipe", global_batch=FUXI_BATCH,
         n_micro=N_MICRO, bucket_slack=SLACK, steps=FUXI_STEPS, losses=frep.stats.losses,
         overflow_max=s["overflow_max"], samples_per_s=samples_per_s,
         tokens_per_s=samples_per_s * fcfg.seq_len, wall_s=wall,
         step_ms=[x * 1e3 for x in frep.stats.step_times],
         step_p50_ms=s["p50_step_s"] * 1e3, step_p99_ms=s["p99_step_s"] * 1e3,
         mean_input_wait_ms=s["mean_input_wait_s"] * 1e3,
         stage_host_ms={k: s[k] for k in ("plan_ms", "retrieve_ms", "commit_ms")},
         launches=fuxi_launches, max_memory_allocated_gb=peak_gb,
         device_memory_gb=torch.cuda.get_device_properties(0).total_memory / 1e9)
    if not all(np.isfinite(frep.stats.losses)) or len(frep.stats.losses) != FUXI_STEPS:
        raise SystemExit(f"FuXi losses are not {FUXI_STEPS} finite values")
    if s["overflow_max"] != 0:
        raise SystemExit(f"FuXi routing overflowed: {s['overflow_max']}")
    fuxi_want = {k: 0 for k in KERNELS}
    fuxi_want.update(embedding_gather=(1 + 3 * N_MICRO) * FUXI_STEPS,
                     segment_rowsum=(N_MICRO + 1) * FUXI_STEPS,
                     buffer_sync=FUXI_STEPS - 1, embedding_scatter=FUXI_STEPS,
                     flash_attention_tf32x3=FUXI_FWD_CALLS_PER_STEP * FUXI_STEPS,
                     flash_attention_bwd_tf32x3=FUXI_BWD_CALLS_PER_STEP * FUXI_STEPS)
    if fuxi_launches != fuxi_want:
        raise SystemExit(f"FuXi launches {fuxi_launches} != {fuxi_want}")

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fsess.train(2)
            torch.cuda.synchronize()
            span = time.perf_counter() - t0
        emit_profile(prof, "fuxi_train_profile", span, steps=2)
        del prof
    del fsess, fwl, frep
    gc.collect()
    torch.cuda.empty_cache()

    # the captured main-path attention calls, on the card alone now: checked
    # at full shape and timed beside the plain versions, SDPA (the yardstick;
    # the port never calls it) and their f32 bound; the forward through the
    # main path's tf32x3 kernel and through the general kernel, both with
    # the lse, timed in turns (general, tf32x3, tf32x3, general)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fuxi_attn, fuxi_err, fwd_checks = {}, {}, {}
    q, k, v, causal = fkept["fwd"]
    if fa.lse_variant(q, k, v) != "tf32x3":
        raise SystemExit("FuXi's main-path forward call is not the tf32x3 kernel's")
    fwd_fns = {"flash_attention_tf32x3": lambda: fa.flash_attention_lse(q, k, v, causal),
               "flash_attention_simple": lambda: fa.flash_attention_simple(q, k, v, causal,
                                                                           lse=True)}
    for kname, fn in fwd_fns.items():
        before = counts()[kname]
        out, lse = fn()
        again = fn()
        if counts()[kname] != before + 2:
            raise SystemExit(f"the main-path forward call did not run {kname}")
        if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
            raise SystemExit(f"the main-path forward call is not deterministic ({kname})")
        del again
        err_max = lse_max = share = 0.0
        for b0 in range(0, q.shape[0], 8):
            sl = slice(b0, b0 + 8)
            want = ref.flash_attention_ref(q[sl], k[sl], v[sl], causal)
            err = (out[sl] - want).abs()
            bound = ref.flash_attention_bound(q[sl], k[sl], v[sl], want, causal)
            if not bool((err <= bound).all()):
                raise SystemExit(f"the main-path forward call beyond its bound ({kname}): "
                                 f"{float(err.max())}")
            share = max(share, float((err / bound).max()))
            lse_want = ref.flash_attention_lse_ref(q[sl], k[sl], causal)
            lerr = (lse[sl] - lse_want).abs()
            if not bool((lerr <= ref.flash_attention_lse_bound(q[sl], k[sl], lse_want,
                                                               causal)).all()):
                raise SystemExit(f"the main-path forward call's lse beyond its bound ({kname})")
            err_max = max(err_max, float(err.max()))
            lse_max = max(lse_max, float(lerr.max()))
            del want, err, bound, lse_want, lerr
        fuxi_err[kname] = err_max
        fwd_checks[kname] = {"max_abs_err": err_max, "lse_max_abs_err": lse_max,
                             "max_share_of_bound": share}
        del out, lse
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ops, nbytes = flash_work(q, k, causal)
    mma_ops = flash_tf32_mma_ops(q, k, causal)
    turns = {kname: [] for kname in fwd_fns}
    for kname in ("flash_attention_simple", "flash_attention_tf32x3",
                  "flash_attention_tf32x3", "flash_attention_simple"):
        turns[kname].append(time_ms(torch, fwd_fns[kname], flush))
    plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, causal), flush)
    library_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=causal), flush)
    for kname, times in turns.items():
        fuxi_attn[kname] = row = {
            "kernel": kname, "call": "fuxi layer 0 forward (with its lse)",
            "shape": list(q.shape), "kv_heads": k.shape[2], "causal": causal,
            "dtype": str(q.dtype).removeprefix("torch."), "operations": ops,
            "bytes": nbytes, "ms": statistics.mean(times), "ms_turns": times,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_call": "scaled_dot_product_attention(is_causal) on (B, H, T, hd) views",
            **f32_work_bound(ops, nbytes, name, peak, peak_fp32), **fwd_checks[kname]}
        row["achieved_tflops"] = ops / row["ms"] / 1e9
        if kname == "flash_attention_tf32x3":
            row["tf32_mma_operations"] = mma_ops
            row["tf32_mma_tflops"] = mma_ops / row["ms"] / 1e9
            row["tf32_peak_share"] = row["tf32_mma_tflops"] * 1e12 / tf32_flops(name)
        emit("kernel_shape", path="fuxi_train", **row)
    del qt, kt, vt

    # the backward call: through the main path's tf32x3 kernel and through
    # the general one, timed in turns (general, tf32x3, tf32x3, general)
    q, k, v, o, do, lse, causal = fkept["bwd"]
    if fa.bwd_variant(q, k, v) != "tf32x3":
        raise SystemExit("FuXi's main-path backward call is not the tf32x3 kernel's")
    errs = check_flash_bwd("main-path backward call", q, k, v, causal, chunk=8,
                           given=(o, do, lse))
    ops, nbytes = flash_bwd_work(q, k, causal)
    mma_ops = flash_bwd_tf32_mma_ops(q, k, causal)
    bwd_fns = {
        "flash_attention_bwd_tf32x3": lambda: fa.flash_attention_bwd(q, k, v, o, do, lse,
                                                                     causal),
        "flash_attention_bwd_simple": lambda: fa.flash_attention_bwd_simple(q, k, v, o, do,
                                                                            lse, causal)}
    turns = {kname: [] for kname in bwd_fns}
    for kname in ("flash_attention_bwd_simple", "flash_attention_bwd_tf32x3",
                  "flash_attention_bwd_tf32x3", "flash_attention_bwd_simple"):
        turns[kname].append(time_ms(torch, bwd_fns[kname], flush))
    plain_ms = time_ms(torch, lambda: ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal),
                       flush)
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    lib_out = sdpa(*leaves, is_causal=causal)
    do_t = do.transpose(1, 2)
    library_ms = time_ms(torch, lambda: torch.autograd.grad(lib_out, leaves, do_t,
                                                            retain_graph=True), flush)
    for kname, times in turns.items():
        fuxi_err[kname] = max(errs[kname.removeprefix("flash_attention_bwd_")].values())
        fuxi_attn[kname] = row = {
            "kernel": kname, "call": "fuxi layer 3 backward",
            "shape": list(q.shape), "kv_heads": k.shape[2], "causal": causal,
            "dtype": str(q.dtype).removeprefix("torch."), "operations": ops, "bytes": nbytes,
            "ms": statistics.mean(times), "ms_turns": times, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library_call": "torch.autograd.grad through scaled_dot_product_attention"
                            "(is_causal) on (B, H, T, hd) views (its backward alone)",
            "max_abs_err": fuxi_err[kname],
            **f32_work_bound(ops, nbytes, name, peak, peak_fp32)}
        row["achieved_tflops"] = ops / row["ms"] / 1e9
        if kname == "flash_attention_bwd_tf32x3":
            row["tf32_mma_operations"] = mma_ops
            row["tf32_mma_tflops"] = mma_ops / row["ms"] / 1e9
            row["tf32_peak_share"] = row["tf32_mma_tflops"] * 1e12 / tf32_flops(name)
        emit("kernel_shape", path="fuxi_train", **row)
    del fkept, q, k, v, o, do, lse, leaves, lib_out, do_t, flush
    gc.collect()
    torch.cuda.empty_cache()
    emit("fuxi_phase", seconds=time.perf_counter() - t_phase)

    # -- 11c. consistency at fuxi-reduced ----------------------------------------
    t_phase = time.perf_counter()
    fuxi_run = reduced_gaps(arch=FUXI_ARCH)
    emit("fuxi_consistency", arch="fuxi-kuairand (reduced)", steps=CONSISTENCY_STEPS,
         **fuxi_run, seconds=time.perf_counter() - t_phase,
         bounds="rows, dense and accum within 1e-5; async more than 1e-6 from the "
                "reference")
    if not fuxi_run["reference_same_bits_twice"]:
        raise SystemExit("the FuXi reference gave other bits on a second run")
    fgaps = fuxi_run["max_diff_to_reference"]
    for key in ("nestpipe", "serial", "nestpipe_vs_serial"):
        if fgaps[key]["rows_dense"] > 1e-5 or fgaps[key]["accum_abs"] > 1e-5:
            raise SystemExit(f"FuXi {key} differs from the reference: {fgaps}")
    if fgaps["async"]["rows_dense"] <= 1e-6:
        raise SystemExit(f"FuXi async did not diverge: {fgaps}")
    gc.collect()
    torch.cuda.empty_cache()

    # -- 12. flash_attention against its plain version -----------------------
    fworst = {"flash_attention_wgmma bfloat16": 0.0, "flash_attention_tf32x3 float32": 0.0,
              "flash_attention_simple float32": 0.0, "flash_attention_simple bfloat16": 0.0}
    fshare = dict.fromkeys(fworst, 0.0)  # the largest |kernel - plain| / bound
    flash_kernels = ("flash_attention_wgmma", "flash_attention_tf32x3", "flash_attention_simple")

    def check_flash(label, q, k, v, causal, chunk=None, simple=False):
        """The kernel ``fa.variant`` picks (or the general one when
        ``simple``) against the plain version within
        ref.flash_attention_bound, ``chunk`` batch rows at a time, the same
        bits on a second run, and only that kernel's counter moved. Returns
        the kernel's name."""
        kind = "simple" if simple else fa.variant(q, k, v)
        kname = f"flash_attention_{kind}"
        fn = fa.flash_attention_simple if simple else fa.flash_attention
        before = counts()
        got = fn(q, k, v, causal)
        if not torch.equal(got, fn(q, k, v, causal)):
            raise SystemExit(f"{kname} is not deterministic at {label}")
        moved = {kn: counts()[kn] - before[kn] for kn in flash_kernels}
        if moved != {kn: 2 * (kn == kname) for kn in flash_kernels}:
            raise SystemExit(f"{label}: {kname} chosen, but launches moved by {moved}")
        step = chunk or q.shape[0]
        for b0 in range(0, q.shape[0], step):
            sl = slice(b0, b0 + step)
            want = ref.flash_attention_ref(q[sl], k[sl], v[sl], causal)
            err = (got[sl].float() - want.float()).abs()
            bound = ref.flash_attention_bound(q[sl], k[sl], v[sl], want, causal)
            if not bool((err <= bound).all()):
                raise SystemExit(f"{kname} beyond its bound at {label}: "
                                 f"{float(err.max())} (bound there "
                                 f"{float(bound.flatten()[int((err - bound).argmax())])})")
            key = f"{kname} {str(q.dtype).removeprefix('torch.')}"
            fworst[key] = max(fworst[key], float(err.max()))
            fshare[key] = max(fshare[key], float((err / bound).max()))
            del want, err, bound
        return kname

    lse_worst = {"flash_attention_wgmma bfloat16": 0.0, "flash_attention_simple bfloat16": 0.0}

    def check_lse(label, q, k, v, causal, simple=False):
        """The row logsumexp of the wgmma kernel (``fa.flash_attention_lse``;
        ``fa.lse_variant`` must pick it) or of the general one
        (``flash_attention_simple(lse=True)``) within
        ref.flash_attention_lse_bound of ref.flash_attention_lse_ref, the
        output with the lse bit for bit the kernel's output without it, one
        launch of that kernel each."""
        kname = "flash_attention_simple" if simple else "flash_attention_wgmma"
        if not simple and fa.lse_variant(q, k, v) != "wgmma":
            raise SystemExit(f"{label}: the lse went to {fa.lse_variant(q, k, v)}")
        before = counts()[kname]
        if simple:
            out, lse = fa.flash_attention_simple(q, k, v, causal, lse=True)
            alone = fa.flash_attention_simple(q, k, v, causal)
        else:
            out, lse = fa.flash_attention_lse(q, k, v, causal)
            alone = fa.flash_attention(q, k, v, causal)
        if counts()[kname] != before + 2:
            raise SystemExit(f"{label}: the lse and the output did not both run {kname}")
        if not torch.equal(out, alone):
            raise SystemExit(f"{kname}'s output with its lse is not its output without "
                             f"at {label}")
        want = ref.flash_attention_lse_ref(q, k, causal)
        err = (lse - want).abs()
        if not bool((err <= ref.flash_attention_lse_bound(q, k, want, causal)).all()):
            raise SystemExit(f"{kname}'s lse beyond its bound at {label}: {float(err.max())}")
        key = f"{kname} {str(q.dtype).removeprefix('torch.')}"
        lse_worst[key] = max(lse_worst[key], float(err.max()))
        del out, lse, alone, want, err

    fedge = []
    head_dims = (16, 64, 80, 128, 160, 192, 256)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for t in (1, 33, 64, 257, 2048):
            for hd in head_dims:
                for kv in (4, 1):  # H/KV 1 and 4
                    for causal in (True, False):
                        case = (f"T={t} hd={hd} H/KV={4 // kv} causal={causal} {dname}",
                                *flash_inputs(1, t, t, 4, kv, hd, dtype), causal)
                        kname = check_flash(*case)
                        if dtype == torch.bfloat16:
                            want = ("flash_attention_wgmma" if hd in fa.WGMMA_HEAD_DIMS
                                    else "flash_attention_simple")
                        else:
                            want = ("flash_attention_tf32x3" if hd <= fa.TF32X3_MAX_HEAD_DIM
                                    else "flash_attention_simple")
                        if kname != want:
                            raise SystemExit(f"{case[0]} went to {kname}, not {want}")
                        if (kname == "flash_attention_tf32x3"
                                or (kname == "flash_attention_wgmma" and t in (33, 257))):
                            check_flash(*case, simple=True)  # the general kernel too
                        if kname == "flash_attention_wgmma":  # its lse, and the general one's
                            check_lse(*case)
                            if t in (33, 257):
                                check_lse(*case, simple=True)
            fedge.append(f"{dname} T={t} hd in {head_dims} H/KV in {{1,4}} causal and not"
                         + (" (wgmma, with and without its lse; the general kernel too "
                            "at T 33, 257, with and without its lse)"
                            if dtype == torch.bfloat16 else
                            " (tf32x3 at hd <= 128, and the general kernel too)"))
        for hd in ((64, 160) if dtype == torch.float32 else (160,)):
            for causal in (False, True):
                case = (f"Tq=33 Tk=100 hd={hd} causal={causal} {dname}",
                        *flash_inputs(2, 33, 100, 4, 1, hd, dtype), causal)
                kname = check_flash(*case)
                if kname != "flash_attention_simple":
                    check_flash(*case, simple=True)
            fedge.append(f"{dname} Tq=33 Tk=100 hd={hd} H/KV=4 causal and not")
        # strided views: column slices of one wider tensor, 16-byte loads off
        # (in bf16, copied for the wgmma kernel), and 16-byte aligned as a
        # fused projection makes them (read in place)
        for hd in ((64, 160) if dtype == torch.float32 else (160,)):
            for off in (3, 8):
                wide = torch.empty((2, 100, 4, 3 * hd + off), device=dev).normal_(
                    generator=g).to(dtype)
                views = (wide[..., off:off + hd], wide[..., off + hd:off + 2 * hd],
                         wide[..., off + 2 * hd:off + 3 * hd])
                kname = check_flash(f"strided {dname} hd {hd} offset {off}", *views, True)
                if kname == "flash_attention_wgmma":
                    check_lse(f"strided {dname} hd {hd} offset {off}", *views, True)
                fedge.append(f"{dname} strided q, k, v (T=100, hd={hd}, {off} elements in): "
                             f"{kname}")
    # values of one sign at FuXi's shape (v shifted by 2; q and k times 1, 2
    # and 3: scores of std ~1, 4 and 9), where MMA sums run long in one
    # direction, three draws each, through both f32 kernels, each draw's
    # share of the bound against an f64 evaluation and against the plain f32
    # version printed (the plain version's own score rounding grows with
    # |q . k|, so the second share carries both errors). The first draw at
    # x 2 goes through check_flash. Held within the bound of the f64
    # evaluation: the tf32x3 kernel at every scale, the general kernel at
    # x 1 and 2. The bound leaves out the scores' own rounding, and the
    # general kernel's f32 FFMA scores at x 3 lie past it (1.43 of it in
    # its first run), so there its share is printed, not held
    def exact_attention(q, k, v):
        """Causal softmax attention of (B, T, H, hd) inputs in f64."""
        s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * q.shape[-1] ** -0.5
        t = q.shape[1]
        keep = torch.ones((t, t), dtype=torch.bool, device=dev).tril()
        s = s.masked_fill(~keep, float("-inf"))
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v.double())

    same_sign = []
    for scale in (1, 2, 3):
        for draw in range(3):
            q, k, v = flash_inputs(64, 512, 512, 8, 8, 64, torch.float32)
            q, k, v = scale * q, scale * k, v + 2
            for simple in (False, True):
                if scale == 2 and draw == 0:
                    check_flash("same-sign f32 at FuXi's shape", q, k, v, True, chunk=8,
                                simple=simple)
                kname = "flash_attention_simple" if simple else "flash_attention_tf32x3"
                fn = fa.flash_attention_simple if simple else fa.flash_attention
                got = fn(q, k, v, True)
                of_plain = of_exact = 0.0
                for b0 in range(0, q.shape[0], 8):
                    sl = slice(b0, b0 + 8)
                    want = ref.flash_attention_ref(q[sl], k[sl], v[sl], True)
                    bound = ref.flash_attention_bound(q[sl], k[sl], v[sl], want, True)
                    of_plain = max(of_plain, float(((got[sl] - want).abs() / bound).max()))
                    exact = exact_attention(q[sl], k[sl], v[sl])
                    of_exact = max(of_exact, float(((got[sl].double() - exact).abs()
                                                    / bound).max()))
                    del want, bound, exact
                same_sign.append({"kernel": kname, "scale": scale, "draw": draw,
                                  "share_of_bound_vs_plain": of_plain,
                                  "share_of_bound_vs_f64": of_exact,
                                  "held": not simple or scale < 3})
                del got
            del q, k, v
    fedge.append("float32 64 x 512 x 8 x 64 causal, q and k x 1, 2, 3 (3 draws each), v + 2: "
                 "within the bound of an f64 evaluation: tf32x3 at every scale, the general "
                 "kernel at x 1 and 2 (x 2, draw 0: of the plain version too)")
    emit("flash_same_sign", shape=[64, 512, 8, 64], causal=True, cases=same_sign,
         headroom={kn: {str(sc): {ref_: 1 - max(c[f"share_of_bound_vs_{ref_}"]
                                                for c in same_sign
                                                if c["kernel"] == kn and c["scale"] == sc)
                                  for ref_ in ("plain", "f64")}
                        for sc in (1, 2, 3)}
                   for kn in ("flash_attention_tf32x3", "flash_attention_simple")})
    for case in same_sign:
        if case["held"] and case["share_of_bound_vs_f64"] > 1:
            raise SystemExit(f"{case['kernel']} beyond its bound of the f64 evaluation on "
                             f"values of one sign: {case}")
    # the layout never picks the kernel: the same values give the same bits
    # in a contiguous layout and in each layout TMA cannot describe (copied)
    base = flash_inputs(2, 100, 100, 4, 1, 160, torch.bfloat16)

    def off_alignment(x):
        flat = torch.zeros(x.numel() + 3, dtype=x.dtype, device=dev)
        return flat[3:].view(x.shape).copy_(x)  # 3 elements off 16-byte alignment

    def stride_164(x):
        return torch.zeros((*x.shape[:-1], 164), dtype=x.dtype, device=dev)[..., :160].copy_(x)

    def heads_outside(x):
        return x.transpose(1, 2).contiguous().transpose(1, 2)

    for causal in (True, False):
        want_bits = fa.flash_attention(*base, causal)
        for layout in (off_alignment, stride_164, heads_outside):
            views = [layout(x) for x in base]
            if not all(torch.equal(a, b) for a, b in zip(views, base)):
                raise SystemExit(f"the {layout.__name__} views do not hold the same values")
            if fa.tma_ok(views[0]):
                raise SystemExit(f"the {layout.__name__} view is one TMA describes")
            before = fa.launches_wgmma
            got = fa.flash_attention(*views, causal)
            if fa.launches_wgmma != before + 1:
                raise SystemExit(f"the {layout.__name__} layout did not run the wgmma kernel")
            if not torch.equal(got, want_bits):
                raise SystemExit(f"the {layout.__name__} layout changed the bits "
                                 f"(causal={causal})")
            fedge.append(f"bf16 T=100 hd=160 {layout.__name__} (causal={causal}): the "
                         "contiguous layout's bits through the wgmma kernel")
    # the same for the tf32x3 kernel in f32: cp.async on 16-byte aligned
    # views, element loads off alignment, the same bits
    base = flash_inputs(2, 100, 100, 4, 1, 64, torch.float32)
    for causal in (True, False):
        want_bits = fa.flash_attention(*base, causal)
        for layout in (off_alignment, heads_outside):
            views = [layout(x) for x in base]
            before = fa.launches_tf32x3
            got = fa.flash_attention(*views, causal)
            if fa.launches_tf32x3 != before + 1:
                raise SystemExit(f"the {layout.__name__} layout did not run the tf32x3 kernel")
            if not torch.equal(got, want_bits):
                raise SystemExit(f"the {layout.__name__} layout changed the tf32x3 kernel's "
                                 f"bits (causal={causal})")
            fedge.append(f"f32 T=100 hd=64 {layout.__name__} (causal={causal}): the "
                         "contiguous layout's bits through the tf32x3 kernel")
    del base, want_bits, got, views
    try:
        x = torch.zeros((1, 8, 2, 16), device=dev)
        dispatch.flash_attention(x, x.cpu(), x)
    except ValueError:
        fedge.append("a CUDA tensor beside a CPU tensor raises")
    else:
        raise SystemExit("flash_attention took a CPU tensor beside CUDA ones")
    torch.cuda.synchronize()
    emit("flash_kernel_edges", cases=fedge, max_abs_err=dict(fworst),
         max_share_of_bound=fshare, lse_max_abs_err=lse_worst,
         tolerance="|kernel - plain| <= 1e-5 M + 1e-7 (f32) or 2**-8 M + one bf16 ulp of "
                   "the plain output (bf16), M = sum_j w_ij |v_j|; the same bits on two runs")

    # -- 13. main path: full-width stablelm-12b serving -----------------------
    from torch.autograd import DeviceType

    lm = Session.from_arch(LM_ARCH, seed=0)
    lwl, lcfg = lm.workload, lm.workload.cfg
    n_lm_layers = lcfg.n_layers
    decode_steps = LM_GEN - 1
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, ltable = lm.lm_weights()  # the draw the serves below read
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    weights_gb = sum(p_.numel() * p_.element_size() for p_ in params.values()) / 1e9
    # warm-up serve, keeping the first and the last layer's flash_attention
    # inputs and the gathers of two lookups (serve_keeping_gathers)
    kept_flash, flash_calls = {}, [0]
    real_flash = dispatch.flash_attention

    def flash_spy(q, k, v, causal=True):
        i = flash_calls[0]
        flash_calls[0] += 1
        if i in (0, n_lm_layers - 1):
            kept_flash[i] = (q.clone(), k.clone(), v.clone(), causal)
        return real_flash(q, k, v, causal)

    dispatch.flash_attention = flash_spy
    try:
        t0 = time.perf_counter()
        warm, kept_gather, n_gathers = serve_keeping_gathers(
            ltable, lambda: lm.serve(batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN))
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    finally:
        dispatch.flash_attention = real_flash
    if flash_calls[0] != n_lm_layers:
        raise SystemExit(f"the warm-up serve made {flash_calls[0]} flash calls")
    # the gathers at this path's shapes (the master's 5,120-wide f32 rows,
    # then bf16 rows), bit-exact against the plain version and timed
    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)  # evicts the L2 (time_ms)
    lm_gathers = check_serve_gathers("lm_serve", kept_gather, n_gathers, 1 + decode_steps,
                                     ltable)
    del kept_gather
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    lrep = lm.serve(batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN)
    torch.cuda.synchronize()
    lm_launches = counts()
    lm_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ls = lrep.summary
    emit("lm_serve", arch=LM_ARCH, batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN,
         reduced="batch 8, prompt 2048, 32 generated (decode_32k: batch 128 x 32,768)",
         config={k: getattr(lcfg, k) for k in ("n_layers", "d_model", "d_ff",
                                               "vocab_size", "param_dtype",
                                               "compute_dtype")},
         heads=[lcfg.attention.n_heads, lcfg.attention.n_kv_heads, lcfg.attention.head_dim],
         weights_gb=weights_gb, table_gb=ltable.rows.numel() * 4 / 1e9,
         prefill_s=ls["prefill_s"], prompt_tokens_per_s=LM_BATCH * LM_PROMPT / ls["prefill_s"],
         decode_s=ls["decode_s"], decode_step_ms=ls["decode_s"] / decode_steps * 1e3,
         generated_tokens_per_s=ls["tokens_per_s"], weights_draw_s=draw_s,
         warmup_serve_s=warm_s,
         launches=lm_launches, max_memory_allocated_gb=lm_peak_gb,
         sample_tokens=ls["sample_tokens"])
    lm_want = {k: 0 for k in KERNELS}
    # every prefill call through the main-path kernel
    lm_want.update(embedding_gather=3 * (1 + decode_steps), flash_attention_wgmma=n_lm_layers)
    if lm_launches != lm_want:  # 3 gathers a lookup: master, then two assembly
        raise SystemExit(f"LM serving launches {lm_launches} != {lm_want}")
    if not np.array_equal(lrep.tokens, warm.tokens):
        raise SystemExit("two serves of the same weights generated different tokens")
    if lrep.tokens.shape != (LM_BATCH, LM_GEN) or not (
            (0 <= lrep.tokens) & (lrep.tokens < lcfg.vocab_size)).all():
        raise SystemExit(f"generated tokens {lrep.tokens.shape} are not vocabulary ids")

    # the prefill once more with the kernel, and once with the plain
    # attention (here only; the port has no switch), on the serve's prompts
    toks = np.random.default_rng(lm.seed).integers(0, lcfg.vocab_size,
                                                   size=(LM_BATCH, LM_PROMPT))
    with torch.inference_mode():
        keys = lwl.spec.scramble(torch.as_tensor(toks.astype(np.int32), device=dev))
        emb, _ = lwl.engine.lookup_from_master(ltable, keys)
        logits_k, cache = lwl.bundle.prefill(params, emb, cache_len=LM_PROMPT + LM_GEN)
        del cache
        dispatch.flash_attention = ref.flash_attention_ref
        try:
            logits_p, cache = lwl.bundle.prefill(params, emb, cache_len=LM_PROMPT + LM_GEN)
        finally:
            dispatch.flash_attention = real_flash
        del cache, emb
    scale = float(logits_p.abs().max())
    logit_gap = float((logits_k - logits_p).abs().max())
    greedy_agree = float((logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean())
    first_tok = logits_k.argmax(-1).cpu().numpy()
    emit("lm_prefill_vs_plain", max_abs_logit=scale, max_logit_gap=logit_gap,
         gap_share=logit_gap / scale, bound_share=LM_LOGIT_RTOL,
         greedy_tokens_agreeing=greedy_agree,
         first_token_equals_serve=bool(np.array_equal(first_tok, lrep.tokens[:, 0])))
    if not np.isfinite(logits_k.cpu().numpy()).all() or logit_gap > LM_LOGIT_RTOL * scale:
        raise SystemExit(f"prefill logits with the kernel are {logit_gap} from the plain "
                         f"attention's (max |logit| {scale})")
    if not np.array_equal(first_tok, lrep.tokens[:, 0]):
        raise SystemExit("the prefill's argmax is not the serve's first token")
    del logits_k, logits_p

    if args.profile:  # the prefill, then 8 decode steps from its cache
        from torch.profiler import ProfilerActivity, profile

        with torch.inference_mode():
            emb, _ = lwl.engine.lookup_from_master(ltable, keys)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                logits, cache = lwl.bundle.prefill(params, emb,
                                                   cache_len=LM_PROMPT + LM_GEN)
                tok = logits.argmax(-1).to(torch.int32)
                torch.cuda.synchronize()
                span = time.perf_counter() - t0
            emit_profile(prof, "lm_prefill_profile", span, prefills=1)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(8):
                    emb, _ = lwl.engine.lookup_from_master(
                        ltable, lwl.spec.scramble(tok[:, None]))
                    logits, cache = lwl.bundle.decode_step(params, emb, cache)
                    tok = logits.argmax(-1).to(torch.int32)
                    tok.cpu()  # as serve() reads each token back
                torch.cuda.synchronize()
                span = time.perf_counter() - t0
            events = prof.key_averages()
            emit_profile(prof, "lm_decode_profile", span, steps=8,
                         device_kernels_per_step=sum(
                             e.count for e in events if e.device_type != DeviceType.CPU) / 8,
                         host_op_events_per_step=sum(  # nested operators included
                             e.count for e in events if e.device_type == DeviceType.CPU
                             and e.key.startswith("aten::")) / 8)
            del prof, logits, cache, emb
    del lm, params, ltable, lwl, warm, lrep
    gc.collect()
    torch.cuda.empty_cache()

    def prefill_flash_rows(path, kept, flush):
        """The captured prefill calls (layer -> q, k, v, causal): checked at
        full shape through the wgmma kernel and the general one, and timed
        beside the plain version, SDPA (the yardstick; the port never calls
        it) and the bound."""
        rows = []
        for layer, (q, k, v, causal) in sorted(kept.items()):
            if fa.variant(q, k, v) != "wgmma":
                raise SystemExit(f"{path}: the prefill's layer {layer} call is not the "
                                 "wgmma kernel's")
            call = f"prefill layer {layer}"  # a layer's index, or its call's name
            check_flash(f"{path} layer {layer}", q, k, v, causal, chunk=1)
            check_flash(f"{path} layer {layer}, general kernel", q, k, v, causal, chunk=1,
                        simple=True)
            ops, nbytes = flash_work(q, k, causal)
            by_ops, by_bytes = ops / bf16_flops(name) * 1e3, nbytes / peak * 1e3
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            row = {"kernel": "flash_attention_wgmma", "call": call, "kv_shape": list(k.shape),
                   "shape": list(q.shape), "kv_heads": k.shape[2], "causal": causal,
                   "dtype": str(q.dtype).removeprefix("torch."), "operations": ops,
                   "bytes": nbytes,
                   "ms": time_ms(torch, lambda: fa.flash_attention(q, k, v, causal), flush),
                   "simple_ms": time_ms(torch, lambda: fa.flash_attention_simple(
                       q, k, v, causal), flush),
                   "plain_ms": time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, causal),
                                       flush),
                   "library_ms": time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=causal,
                                                             enable_gqa=True), flush),
                   "library_call": "scaled_dot_product_attention(is_causal, enable_gqa) on "
                                   "(B, H, T, hd) views",
                   "bound_ms": max(by_ops, by_bytes),
                   "bound_by": "operations" if by_ops >= by_bytes else "bytes"}
            row["achieved_tflops"] = ops / row["ms"] / 1e9
            row["simple_tflops"] = ops / row["simple_ms"] / 1e9
            rows.append(row)
            emit("kernel_shape", path=path, **row)
            del qt, kt, vt
        return rows

    frows = prefill_flash_rows("lm_serve", kept_flash, flush)
    del kept_flash, flush
    gc.collect()
    torch.cuda.empty_cache()

    # -- 13b. main path: full-width stablelm-3b training ------------------------
    t_phase = time.perf_counter()
    start_gb = torch.cuda.memory_allocated() / 1e9  # what earlier phases left
    tsess = Session.from_arch(LM_TRAIN_ARCH, mode="nestpipe", global_batch=LM_TRAIN_BATCH,
                              seq_len=LM_TRAIN_SEQ, n_micro=N_MICRO, lr=LM_TRAIN_LR, seed=0)
    twl, tcfg = tsess.workload, tsess.workload.cfg
    tdims = twl.engine.dims(twl.batch_shapes["keys"][0][1:], N_MICRO)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tstate = tsess.state
    torch.cuda.synchronize()
    n_params = sum(p_.numel() for p_ in tstate.dense.values())
    emit("lm_train_init", arch=LM_TRAIN_ARCH, seconds=time.perf_counter() - t0,
         config={k: getattr(tcfg, k) for k in ("n_layers", "d_model", "d_ff", "vocab_size",
                                               "param_dtype", "compute_dtype")},
         heads=[tcfg.attention.n_heads, tcfg.attention.n_kv_heads, tcfg.attention.head_dim],
         dense_params=n_params,
         params_gb=sum(p_.numel() * p_.element_size() for p_ in tstate.dense.values()) / 1e9,
         moments_gb=2 * 4 * n_params / 1e9,
         table_rows=tstate.table.rows.shape[0], table_gb=tstate.table.rows.numel() * 4 / 1e9,
         dims={"L": tdims.l_local, "U": tdims.u_max, "C": tdims.cap, "K": tdims.buffer_cap,
               "N": tdims.n_micro},
         start_memory_allocated_gb=start_gb,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    if (tcfg.n_layers, tcfg.d_model, tcfg.d_ff, tcfg.vocab_size) != (32, 2560, 6912, 50304) \
            or tstate.table.rows.shape[1] != 2560 or tstate.table.rows.device.type != "cuda":
        raise SystemExit(f"{LM_TRAIN_ARCH} is not at full width on the card")
    del tstate
    # an unchecked warm-up step; its loss is the run's first (its report is
    # not kept: a report's state holds that step's 5.33 GB of params)
    first_loss = tsess.train(1).stats.losses[0]
    torch.cuda.synchronize()

    # two steps with the first forward (with its lse) and backward call kept
    # (every call counted) and, as on the DLRM path, the embedding kernels' calls
    seen = {"fwd": 0, "bwd": 0}
    tkept = {}
    real_lse, real_fbwd = fa.flash_attention_lse, fa.flash_attention_bwd

    def lm_lse_spy(q, k, v, causal=True):
        seen["fwd"] += 1
        if "fwd" not in tkept:
            tkept["fwd"] = (q.clone(), k.clone(), v.clone(), causal)
        return real_lse(q, k, v, causal)

    def lm_bwd_spy(q, k, v, o, do, lse, causal=True):
        seen["bwd"] += 1
        if "bwd" not in tkept:
            tkept["bwd"] = (*(x.clone() for x in (q, k, v, o, do, lse)), causal)
        return real_fbwd(q, k, v, o, do, lse, causal)

    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)  # evicts the L2 (time_ms)
    fa.flash_attention_lse, fa.flash_attention_bwd = lm_lse_spy, lm_bwd_spy
    try:
        tcaptured = capture_calls(tsess)
    finally:
        fa.flash_attention_lse, fa.flash_attention_bwd = real_lse, real_fbwd
    if seen != {"fwd": 2 * LM_FWD_CALLS_PER_STEP, "bwd": 2 * LM_BWD_CALLS_PER_STEP}:
        raise SystemExit(f"two LM steps made {seen} attention calls")
    # the embedding kernels at this path's shapes (D = 2,560, f32 retrieve and
    # buffer rows, bf16 assembly), while the master lives
    tshapes = check_and_time("lm_train", tcaptured, tsess.state.table)
    del tcaptured
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trep = tsess.train(LM_TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lm_train_launches = counts()
    lm_train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    s = trep.summary
    samples_per_s = LM_TRAIN_BATCH * LM_TRAIN_STEPS / wall
    emit("lm_train", arch=LM_TRAIN_ARCH, mode="nestpipe", global_batch=LM_TRAIN_BATCH,
         seq_len=LM_TRAIN_SEQ, n_micro=N_MICRO, steps=LM_TRAIN_STEPS, lr=LM_TRAIN_LR,
         reduced="depth and widths whole; batch 8 of train_4k's 256 (one of 32 workers)",
         first_loss=first_loss, losses=trep.stats.losses, overflow_max=s["overflow_max"],
         samples_per_s=samples_per_s, tokens_per_s=samples_per_s * LM_TRAIN_SEQ,
         wall_s=wall, step_ms=[x * 1e3 for x in trep.stats.step_times],
         step_p50_ms=s["p50_step_s"] * 1e3, step_p99_ms=s["p99_step_s"] * 1e3,
         mean_input_wait_ms=s["mean_input_wait_s"] * 1e3,
         stage_host_ms={k: s[k] for k in ("plan_ms", "retrieve_ms", "commit_ms")},
         launches=lm_train_launches, max_memory_allocated_gb=lm_train_peak_gb,
         device_memory_gb=torch.cuda.get_device_properties(0).total_memory / 1e9)
    if not all(np.isfinite(trep.stats.losses)) or len(trep.stats.losses) != LM_TRAIN_STEPS:
        raise SystemExit(f"LM losses are not {LM_TRAIN_STEPS} finite values")
    if not all(x < first_loss for x in trep.stats.losses):
        raise SystemExit(f"the LM loss did not fall from {first_loss}: {trep.stats.losses}")
    if s["overflow_max"] != 0:
        raise SystemExit(f"LM routing overflowed: {s['overflow_max']}")
    if lm_train_peak_gb >= 80:
        raise SystemExit(f"LM training peaked at {lm_train_peak_gb} GB")
    lm_train_want = {k: 0 for k in KERNELS}
    lm_train_want.update(embedding_gather=(1 + 3 * N_MICRO) * LM_TRAIN_STEPS,
                         segment_rowsum=(N_MICRO + 1) * LM_TRAIN_STEPS,
                         buffer_sync=LM_TRAIN_STEPS - 1, embedding_scatter=LM_TRAIN_STEPS,
                         flash_attention_wgmma=LM_FWD_CALLS_PER_STEP * LM_TRAIN_STEPS,
                         flash_attention_bwd_wgmma=LM_BWD_CALLS_PER_STEP * LM_TRAIN_STEPS)
    if lm_train_launches != lm_train_want:
        raise SystemExit(f"LM training launches {lm_train_launches} != {lm_train_want}")

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tsess.train(2)
            torch.cuda.synchronize()
            span = time.perf_counter() - t0
        emit_profile(prof, "lm_train_profile", span, steps=2)
        del prof
    del tsess, twl, trep
    gc.collect()
    torch.cuda.empty_cache()

    def train_attention_rows(path, kept, flush, bwd_layer, wgmma_first=False):
        """The captured main-path attention calls of LM training (kept: the
        first forward with its lse, the first backward), on the card alone
        now: checked at full shape and timed beside the plain versions, SDPA
        (the yardstick; the port never calls it) and their bf16 bound; the
        wgmma forward with and without its lse in turns (with, without,
        without, with); the backward through the main path's wgmma kernel
        and the general one in turns (general, wgmma, wgmma, general, or
        with ``wgmma_first`` wgmma, general, general, wgmma), the wgmma one
        at least 10x faster."""
        attn = {}
        q, k, v, causal = kept["fwd"]
        if fa.lse_variant(q, k, v) != "wgmma":
            raise SystemExit(f"{path}: the main-path forward call is not the wgmma kernel's")
        check_flash(f"{path} layer 0 forward", q, k, v, causal, chunk=1)
        check_flash(f"{path} layer 0 forward, general kernel", q, k, v, causal, chunk=1,
                    simple=True)
        check_lse(f"{path} layer 0 forward", q, k, v, causal)
        check_lse(f"{path} layer 0 forward, general kernel", q, k, v, causal,
                  simple=True)
        ops, nbytes = flash_work(q, k, causal)
        by_ops, by_bytes = ops / bf16_flops(name) * 1e3, (nbytes + 4 * q.shape[0] * q.shape[1]
                                                          * q.shape[2]) / peak * 1e3
        fwd_fns = {"with_lse": lambda: fa.flash_attention_lse(q, k, v, causal),
                   "without_lse": lambda: fa.flash_attention(q, k, v, causal)}
        turns = {kind: [] for kind in fwd_fns}
        for kind in ("with_lse", "without_lse", "without_lse", "with_lse"):
            turns[kind].append(time_ms(torch, fwd_fns[kind], flush))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row = {"kernel": "flash_attention_wgmma",
               "call": f"{path} layer 0 forward (with its lse)",
               "shape": list(q.shape), "kv_heads": k.shape[2], "causal": causal,
               "dtype": str(q.dtype).removeprefix("torch."), "operations": ops,
               "bytes": nbytes + 4 * q.shape[0] * q.shape[1] * q.shape[2],
               "ms": statistics.mean(turns["with_lse"]), "ms_turns": turns["with_lse"],
               "without_lse_ms": statistics.mean(turns["without_lse"]),
               "without_lse_ms_turns": turns["without_lse"],
               "simple_ms": time_ms(torch, lambda: fa.flash_attention_simple(q, k, v, causal,
                                                                             lse=True), flush),
               "plain_ms": time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, causal), flush),
               "library_ms": time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=causal,
                                                         enable_gqa=True), flush),
               "library_call": "scaled_dot_product_attention(is_causal, enable_gqa) on "
                               "(B, H, T, hd) views",
               "bound_ms": max(by_ops, by_bytes),
               "bound_by": "operations" if by_ops >= by_bytes else "bytes"}
        row["achieved_tflops"] = ops / row["ms"] / 1e9
        row["simple_tflops"] = ops / row["simple_ms"] / 1e9
        attn["flash_attention_wgmma"] = row
        emit("kernel_shape", path=path, **row)
        del qt, kt, vt

        # the backward call through the wgmma kernel (the main path's) and the
        # general one, checked and timed in turns
        q, k, v, o, do, lse, causal = kept["bwd"]
        if fa.bwd_variant(q, k, v) != "wgmma":
            raise SystemExit(f"{path}: the main-path backward call is not the wgmma kernel's")
        errs = check_flash_bwd(f"{path} backward call", q, k, v, causal, chunk=1,
                               given=(o, do, lse))
        ops, nbytes = flash_bwd_work(q, k, causal)
        by_ops, by_bytes = ops / bf16_flops(name) * 1e3, nbytes / peak * 1e3
        plain_ms = time_ms(torch, lambda: ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal),
                           flush)
        leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
        lib_out = sdpa(*leaves, is_causal=causal, enable_gqa=True)
        do_t = do.transpose(1, 2)
        library_ms = time_ms(torch, lambda: torch.autograd.grad(lib_out, leaves, do_t,
                                                                retain_graph=True), flush)
        bwd_fns = {
            "flash_attention_bwd_simple": lambda: fa.flash_attention_bwd_simple(q, k, v, o, do,
                                                                                lse, causal),
            "flash_attention_bwd_wgmma": lambda: fa.flash_attention_bwd(q, k, v, o, do, lse,
                                                                        causal)}
        outer, inner = "flash_attention_bwd_simple", "flash_attention_bwd_wgmma"
        if wgmma_first:
            outer, inner = inner, outer
        order = (outer, inner, inner, outer)
        turns = {kname: [] for kname in bwd_fns}
        for kname in order:
            turns[kname].append(time_ms(torch, bwd_fns[kname], flush))
        for kname, times in turns.items():
            row = {"kernel": kname, "call": f"{path} layer {bwd_layer} backward",
                   "shape": list(q.shape), "kv_heads": k.shape[2], "causal": causal,
                   "dtype": str(q.dtype).removeprefix("torch."), "operations": ops,
                   "bytes": nbytes, "ms": statistics.mean(times), "ms_turns": times,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "library_call": "torch.autograd.grad through scaled_dot_product_attention"
                                   "(is_causal, enable_gqa) on (B, H, T, hd) views (its "
                                   "backward alone)",
                   "max_abs_err": max(errs[kname.removeprefix("flash_attention_bwd_")].values()),
                   "bound_ms": max(by_ops, by_bytes),
                   "bound_by": "operations" if by_ops >= by_bytes else "bytes"}
            row["achieved_tflops"] = ops / row["ms"] / 1e9
            row["x_library"] = row["ms"] / library_ms
            attn[kname] = row
            emit("kernel_shape", path=path, **row)
        attn["flash_attention_bwd_wgmma"]["x_faster_than_simple"] = (
            attn["flash_attention_bwd_simple"]["ms"] / attn["flash_attention_bwd_wgmma"]["ms"])
        if attn["flash_attention_bwd_wgmma"]["x_faster_than_simple"] < 10:
            raise SystemExit(f"the wgmma backward is less than 10x faster than the general "
                             f"one: {attn['flash_attention_bwd_wgmma']}")
        return attn

    lm_attn = train_attention_rows("lm_train", tkept, flush, tcfg.n_layers - 1)
    del tkept, flush
    gc.collect()
    torch.cuda.empty_cache()
    emit("lm_train_phase", seconds=time.perf_counter() - t_phase)

    # -- 13c. LM consistency ------------------------------------------------------
    t_phase = time.perf_counter()
    lm_runs = {"adam_eps_1e-6": reduced_gaps(adam_eps=1e-6, arch=LM_TRAIN_ARCH),
               "default_step_sizes": reduced_gaps(arch=LM_TRAIN_ARCH)}
    # a 2-layer stablelm-3b at its own head dim and types (2 heads of 80, bf16)
    # on the card and on the CPU from one state
    red = get_arch(LM_TRAIN_ARCH).reduced
    bcfg = dataclasses.replace(red, name="stablelm-3b-bf16-hd80", d_model=160, d_ff=432,
                               param_dtype="bfloat16", compute_dtype="bfloat16",
                               attention=dataclasses.replace(red.attention, n_heads=2,
                                                             n_kv_heads=2, head_dim=80))
    barch = ArchSpec(bcfg.name, "lm", bcfg, bcfg)
    bkw = dict(global_batch=8, seq_len=200, t_chunk=64)
    bgpu = Session.from_workload(assemble_workload(barch, bcfg, device=dev, **bkw), seed=3)
    bcpu = Session.from_workload(assemble_workload(barch, bcfg, device="cpu", **bkw), seed=3)
    bcpu.state = clone_state(bgpu.state, "cpu")
    reset_counts()
    bgot, bwant = bgpu.train(3), bcpu.train(3)
    bf16_launches = {k: v for k, v in counts().items() if v}
    bf16_gap = [abs(a - b) / abs(b) for a, b in zip(bgot.stats.losses, bwant.stats.losses)]
    emit("lm_consistency", arch=f"{LM_TRAIN_ARCH} (reduced)", steps=CONSISTENCY_STEPS,
         **lm_runs, bf16_hd80={"config": "2 layers, 2 heads of 80, d_model 160, bf16",
                               "losses_card": bgot.stats.losses,
                               "losses_cpu": bwant.stats.losses,
                               "relative_gap": bf16_gap, "bound": LM_BF16_LOSS_RTOL,
                               "launches": bf16_launches},
         seconds=time.perf_counter() - t_phase,
         bounds="rows, dense and accum within 1e-5 at AdamW eps 1e-6 and at the default "
                "eps; async more than 1e-6 from the reference; the bf16 config's losses "
                f"within {LM_BF16_LOSS_RTOL} of the CPU's")
    for label, run in lm_runs.items():
        if not run["reference_same_bits_twice"]:
            raise SystemExit(f"the LM reference gave other bits on a second run ({label})")
        lgaps = run["max_diff_to_reference"]
        for key in ("nestpipe", "serial", "nestpipe_vs_serial"):
            if lgaps[key]["rows_dense"] > 1e-5 or lgaps[key]["accum_abs"] > 1e-5:
                raise SystemExit(f"LM {key} differs from the reference ({label}): {lgaps}")
        if lgaps["async"]["rows_dense"] <= 1e-6:
            raise SystemExit(f"LM async did not diverge ({label}): {lgaps}")
    if bf16_launches.get("flash_attention_wgmma", 0) != 2 * 2 * N_MICRO * 3 \
            or bf16_launches.get("flash_attention_bwd_wgmma", 0) != 2 * N_MICRO * 3 \
            or bf16_launches.get("flash_attention_bwd_simple", 0) != 0:
        raise SystemExit(f"the bf16 hd-80 config launched {bf16_launches}")
    if not all(np.isfinite(bgot.stats.losses)) or max(bf16_gap) > LM_BF16_LOSS_RTOL:
        raise SystemExit(f"the bf16 hd-80 losses on the card are {bf16_gap} from the CPU's")
    del bgpu, bcpu, bgot, bwant
    gc.collect()
    torch.cuda.empty_cache()

    # -- 13d. main path: full-width olmoe-1b-7b serving ----------------------
    # every width and all 16 layers (64 experts top-8, 16 heads of 128, bf16)
    # through Session.from_arch, as stablelm-12b's cell: the same tokens
    # twice, the launches counted, the prefill against the plain attention;
    # the capacity's dropped picks counted in the warm-up serve
    t_phase = time.perf_counter()
    start_gb = torch.cuda.memory_allocated() / 1e9
    msess = Session.from_arch(MOE_ARCH, seed=0)
    mwl, mcfg = msess.workload, msess.workload.cfg
    if (mcfg.n_layers, mcfg.d_model, mcfg.d_ff, mcfg.moe.num_experts, mcfg.moe.top_k,
            mcfg.attention.head_dim) != (16, 2048, 1024, 64, 8, 128):
        raise SystemExit(f"{MOE_ARCH} is not at its published widths")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mparams, mtable = msess.lm_weights()
    torch.cuda.synchronize()
    mdraw_s = time.perf_counter() - t0
    mweights_gb = sum(p_.numel() * p_.element_size() for p_ in mparams.values()) / 1e9
    kept_mflash, mflash_calls = {}, [0]
    drops = {"prefill": [], "decode": []}  # dropped picks a MoE call
    real_flash, real_slots = dispatch.flash_attention, mlayers.moe_slots

    def mflash_spy(q, k, v, causal=True):
        i = mflash_calls[0]
        mflash_calls[0] += 1
        if i in (0, mcfg.n_layers - 1):
            kept_mflash[i] = (q.clone(), k.clone(), v.clone(), causal)
        return real_flash(q, k, v, causal)

    def slots_spy(ids, w, num_experts, cap):
        out = real_slots(ids, w, num_experts, cap)
        kind = "prefill" if ids.shape[0] > LM_BATCH else "decode"
        drops[kind].append(int((out.pick_slot < 0).sum()))
        return out

    dispatch.flash_attention, mlayers.moe_slots = mflash_spy, slots_spy
    try:
        t0 = time.perf_counter()
        mwarm = msess.serve(batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN)
        torch.cuda.synchronize()
        mwarm_s = time.perf_counter() - t0
    finally:
        dispatch.flash_attention, mlayers.moe_slots = real_flash, real_slots
    if mflash_calls[0] != mcfg.n_layers or len(drops["prefill"]) != mcfg.n_layers \
            or len(drops["decode"]) != mcfg.n_layers * decode_steps:
        raise SystemExit(f"the warm-up olmoe serve made {mflash_calls[0]} flash calls and "
                         f"{len(drops['prefill'])} + {len(drops['decode'])} MoE calls")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    mrep = msess.serve(batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN)
    torch.cuda.synchronize()
    moe_serve_launches = counts()
    moe_serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms_ = mrep.summary
    picks = LM_BATCH * LM_PROMPT * mcfg.moe.top_k
    emit("moe_serve", arch=MOE_ARCH, batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN,
         reduced="batch 8, prompt 2048, 32 generated; every width, all 16 layers",
         config={k: getattr(mcfg, k) for k in ("n_layers", "d_model", "d_ff", "vocab_size",
                                               "param_dtype", "compute_dtype")},
         heads=[mcfg.attention.n_heads, mcfg.attention.n_kv_heads, mcfg.attention.head_dim],
         experts=[mcfg.moe.num_experts, mcfg.moe.top_k, mcfg.moe.capacity_factor],
         capacity={"prefill": mlayers.moe_capacity(LM_BATCH * LM_PROMPT, mcfg.moe),
                   "decode": mlayers.moe_capacity(LM_BATCH, mcfg.moe)},
         prefill_dropped_picks_by_layer=drops["prefill"],
         prefill_dropped_share=sum(drops["prefill"]) / (picks * mcfg.n_layers),
         decode_dropped_picks=sum(drops["decode"]),
         weights_gb=mweights_gb, table_gb=mtable.rows.numel() * 4 / 1e9,
         prefill_s=ms_["prefill_s"], prompt_tokens_per_s=LM_BATCH * LM_PROMPT / ms_["prefill_s"],
         decode_s=ms_["decode_s"], decode_step_ms=ms_["decode_s"] / decode_steps * 1e3,
         generated_tokens_per_s=ms_["tokens_per_s"], weights_draw_s=mdraw_s,
         warmup_serve_s=mwarm_s, launches=moe_serve_launches,
         max_memory_allocated_gb=moe_serve_peak_gb, start_memory_allocated_gb=start_gb,
         sample_tokens=ms_["sample_tokens"])
    moe_serve_want = {k: 0 for k in KERNELS}
    moe_serve_want.update(embedding_gather=3 * (1 + decode_steps),
                          flash_attention_wgmma=mcfg.n_layers)
    if moe_serve_launches != moe_serve_want:
        raise SystemExit(f"olmoe serving launches {moe_serve_launches} != {moe_serve_want}")
    if not np.array_equal(mrep.tokens, mwarm.tokens):
        raise SystemExit("two olmoe serves of the same weights generated different tokens")
    if mrep.tokens.shape != (LM_BATCH, LM_GEN) or not (
            (0 <= mrep.tokens) & (mrep.tokens < mcfg.vocab_size)).all():
        raise SystemExit(f"olmoe tokens {mrep.tokens.shape} are not vocabulary ids")

    # the prefill once more with the kernel, and once with the plain attention
    toks = np.random.default_rng(msess.seed).integers(0, mcfg.vocab_size,
                                                      size=(LM_BATCH, LM_PROMPT))
    with torch.inference_mode():
        mkeys = mwl.spec.scramble(torch.as_tensor(toks.astype(np.int32), device=dev))
        emb, _ = mwl.engine.lookup_from_master(mtable, mkeys)
        logits_k, cache = mwl.bundle.prefill(mparams, emb, cache_len=LM_PROMPT + LM_GEN)
        del cache
        dispatch.flash_attention = ref.flash_attention_ref
        try:
            logits_p, cache = mwl.bundle.prefill(mparams, emb, cache_len=LM_PROMPT + LM_GEN)
        finally:
            dispatch.flash_attention = real_flash
        del cache, emb
    scale = float(logits_p.abs().max())
    logit_gap = float((logits_k - logits_p).abs().max())
    first_tok = logits_k.argmax(-1).cpu().numpy()
    emit("moe_prefill_vs_plain", max_abs_logit=scale, max_logit_gap=logit_gap,
         gap_share=logit_gap / scale, bound_share=LM_LOGIT_RTOL,
         greedy_tokens_agreeing=float((logits_k.argmax(-1) == logits_p.argmax(-1))
                                      .float().mean()),
         first_token_equals_serve=bool(np.array_equal(first_tok, mrep.tokens[:, 0])))
    if not np.isfinite(logits_k.cpu().numpy()).all() or logit_gap > LM_LOGIT_RTOL * scale:
        raise SystemExit(f"olmoe prefill logits with the kernel are {logit_gap} from the "
                         f"plain attention's (max |logit| {scale})")
    if not np.array_equal(first_tok, mrep.tokens[:, 0]):
        raise SystemExit("the olmoe prefill's argmax is not the serve's first token")
    del logits_k, logits_p

    if args.profile:  # the prefill, then 8 decode steps from its cache
        from torch.profiler import ProfilerActivity, profile

        with torch.inference_mode():
            emb, _ = mwl.engine.lookup_from_master(mtable, mkeys)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                logits, cache = mwl.bundle.prefill(mparams, emb, cache_len=LM_PROMPT + LM_GEN)
                tok = logits.argmax(-1).to(torch.int32)
                torch.cuda.synchronize()
                span = time.perf_counter() - t0
            emit_profile(prof, "moe_prefill_profile", span, prefills=1)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(8):
                    emb, _ = mwl.engine.lookup_from_master(mtable, mwl.spec.scramble(tok[:, None]))
                    logits, cache = mwl.bundle.decode_step(mparams, emb, cache)
                    tok = logits.argmax(-1).to(torch.int32)
                    tok.cpu()  # as serve() reads each token back
                torch.cuda.synchronize()
                span = time.perf_counter() - t0
            events = prof.key_averages()
            emit_profile(prof, "moe_decode_profile", span, steps=8,
                         device_kernels_per_step=sum(
                             e.count for e in events if e.device_type != DeviceType.CPU) / 8)
            del prof, logits, cache, emb
    del msess, mwl, mparams, mtable, mwarm, mrep
    gc.collect()
    torch.cuda.empty_cache()
    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)  # evicts the L2 (time_ms)
    mfrows = prefill_flash_rows("moe_serve", kept_mflash, flush)
    del kept_mflash, flush
    gc.collect()
    torch.cuda.empty_cache()
    emit("moe_serve_phase", seconds=time.perf_counter() - t_phase)

    # -- 13e. main path: olmoe-1b-7b training at full width, 6 of 16 layers --
    t_phase = time.perf_counter()
    start_gb = torch.cuda.memory_allocated() / 1e9
    mtcfg = dataclasses.replace(get_arch(MOE_ARCH).config, n_layers=MOE_TRAIN_LAYERS)

    def moe_train_session(seed, **kw):
        """olmoe at every width and MOE_TRAIN_LAYERS layers through the
        build path, as Session.from_arch builds stablelm-3b's cell (batch
        8 of 4,096 tokens in N_MICRO micro-batches, AdamW at lr 3e-5)."""
        wl = assemble_workload(
            ArchSpec(MOE_ARCH, "lm", mtcfg, mtcfg), mtcfg, device=dev, mode="nestpipe",
            npcfg=NestPipeConfig(fwp_microbatches=N_MICRO, bucket_slack=4.0),
            global_batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ, t_chunk=64)
        return Session.from_workload(wl, opt_cfg=OptimizerConfig(lr=LM_TRAIN_LR),
                                     seed=seed, data_seed=0, **kw)

    mts = moe_train_session(0)
    mtwl = mts.workload
    mtdims = mtwl.engine.dims(mtwl.batch_shapes["keys"][0][1:], N_MICRO)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mtstate = mts.state
    torch.cuda.synchronize()
    mt_params = sum(p_.numel() for p_ in mtstate.dense.values())
    emit("moe_train_init", arch=MOE_ARCH, layers=MOE_TRAIN_LAYERS,
         seconds=time.perf_counter() - t0,
         config={k: getattr(mtcfg, k) for k in ("n_layers", "d_model", "d_ff", "vocab_size",
                                                "param_dtype", "compute_dtype")},
         heads=[mtcfg.attention.n_heads, mtcfg.attention.n_kv_heads,
                mtcfg.attention.head_dim],
         experts=[mtcfg.moe.num_experts, mtcfg.moe.top_k, mtcfg.moe.capacity_factor],
         capacity=mlayers.moe_capacity(LM_TRAIN_BATCH // N_MICRO * LM_TRAIN_SEQ, mtcfg.moe),
         dense_params=mt_params,
         params_gb=sum(p_.numel() * p_.element_size() for p_ in mtstate.dense.values()) / 1e9,
         moments_gb=2 * 4 * mt_params / 1e9, table_gb=mtstate.table.rows.numel() * 4 / 1e9,
         dims={"L": mtdims.l_local, "U": mtdims.u_max, "C": mtdims.cap,
               "K": mtdims.buffer_cap, "N": mtdims.n_micro},
         start_memory_allocated_gb=start_gb,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    if mtstate.dense["blocks.0.moe.wi"].shape != (MOE_TRAIN_LAYERS, 64, 2048, 1024) \
            or mtstate.table.rows.shape[1] != 2048 or mtstate.table.rows.device.type != "cuda":
        raise SystemExit(f"{MOE_ARCH} training is not at full width on the card")
    del mtstate
    mfirst = mts.train(1).stats
    mfirst_loss, mfirst_aux = mfirst.losses[0], mfirst.moe_aux[0]
    torch.cuda.synchronize()

    # two steps with the first forward (with its lse) and backward kept, every
    # call counted, each MoE call's dropped picks counted, and the embedding
    # kernels' calls captured
    mseen, mtkept, tdrops = {"fwd": 0, "bwd": 0}, {}, []
    real_lse, real_fbwd = fa.flash_attention_lse, fa.flash_attention_bwd

    def moe_lse_spy(q, k, v, causal=True):
        mseen["fwd"] += 1
        if "fwd" not in mtkept:
            mtkept["fwd"] = (q.clone(), k.clone(), v.clone(), causal)
        return real_lse(q, k, v, causal)

    def moe_bwd_spy(q, k, v, o, do, lse, causal=True):
        mseen["bwd"] += 1
        if "bwd" not in mtkept:
            mtkept["bwd"] = (*(x.clone() for x in (q, k, v, o, do, lse)), causal)
        return real_fbwd(q, k, v, o, do, lse, causal)

    def train_slots_spy(ids, w, num_experts, cap):
        out = real_slots(ids, w, num_experts, cap)
        tdrops.append(int((out.pick_slot < 0).sum()))
        return out

    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)  # evicts the L2 (time_ms)
    fa.flash_attention_lse, fa.flash_attention_bwd = moe_lse_spy, moe_bwd_spy
    mlayers.moe_slots = train_slots_spy
    try:
        mcaptured = capture_calls(mts)
    finally:
        fa.flash_attention_lse, fa.flash_attention_bwd = real_lse, real_fbwd
        mlayers.moe_slots = real_slots
    if mseen != {"fwd": 2 * MOE_FWD_CALLS_PER_STEP, "bwd": 2 * MOE_BWD_CALLS_PER_STEP}:
        raise SystemExit(f"two olmoe steps made {mseen} attention calls")
    mtshapes = check_and_time("moe_train", mcaptured, mts.state.table)
    del mcaptured
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    mtrep = mts.train(MOE_TRAIN_STEPS)
    torch.cuda.synchronize()
    mwall = time.perf_counter() - t0
    moe_train_launches = counts()
    moe_train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    s = mtrep.summary
    msamples_per_s = LM_TRAIN_BATCH * MOE_TRAIN_STEPS / mwall
    mt_tokens = LM_TRAIN_BATCH // N_MICRO * LM_TRAIN_SEQ  # a micro-batch's
    emit("moe_train", arch=MOE_ARCH, layers=MOE_TRAIN_LAYERS, mode="nestpipe",
         global_batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ, n_micro=N_MICRO,
         steps=MOE_TRAIN_STEPS, lr=LM_TRAIN_LR,
         reduced=f"every width, {MOE_TRAIN_LAYERS} of 16 layers; batch 8 of train_4k's "
                 "256 (one of 32 workers)",
         first_loss=mfirst_loss, first_moe_aux=mfirst_aux, losses=mtrep.stats.losses,
         moe_aux=mtrep.stats.moe_aux, overflow_max=s["overflow_max"],
         dropped_picks_by_call=tdrops,
         dropped_share=sum(tdrops) / (len(tdrops) * mt_tokens * mtcfg.moe.top_k),
         samples_per_s=msamples_per_s, tokens_per_s=msamples_per_s * LM_TRAIN_SEQ,
         wall_s=mwall, step_ms=[x * 1e3 for x in mtrep.stats.step_times],
         step_p50_ms=s["p50_step_s"] * 1e3, step_p99_ms=s["p99_step_s"] * 1e3,
         mean_input_wait_ms=s["mean_input_wait_s"] * 1e3,
         stage_host_ms={k: s[k] for k in ("plan_ms", "retrieve_ms", "commit_ms")},
         launches=moe_train_launches, max_memory_allocated_gb=moe_train_peak_gb,
         device_memory_gb=torch.cuda.get_device_properties(0).total_memory / 1e9)
    if not all(np.isfinite(mtrep.stats.losses)) or len(mtrep.stats.losses) != MOE_TRAIN_STEPS:
        raise SystemExit(f"olmoe losses are not {MOE_TRAIN_STEPS} finite values")
    if not all(x < mfirst_loss for x in mtrep.stats.losses):
        raise SystemExit(f"the olmoe loss did not fall from {mfirst_loss}: "
                         f"{mtrep.stats.losses}")
    if len(mtrep.stats.moe_aux) != MOE_TRAIN_STEPS or not all(
            np.isfinite(a_) and a_ > 0 for a_ in mtrep.stats.moe_aux):
        raise SystemExit(f"olmoe's moe_aux is not positive each step: {mtrep.stats.moe_aux}")
    if s["overflow_max"] != 0:
        raise SystemExit(f"olmoe routing overflowed: {s['overflow_max']}")
    if moe_train_peak_gb >= 80:
        raise SystemExit(f"olmoe training peaked at {moe_train_peak_gb} GB")
    moe_train_want = {k: 0 for k in KERNELS}
    moe_train_want.update(embedding_gather=(1 + 3 * N_MICRO) * MOE_TRAIN_STEPS,
                          segment_rowsum=(N_MICRO + 1) * MOE_TRAIN_STEPS,
                          buffer_sync=MOE_TRAIN_STEPS - 1, embedding_scatter=MOE_TRAIN_STEPS,
                          flash_attention_wgmma=MOE_FWD_CALLS_PER_STEP * MOE_TRAIN_STEPS,
                          flash_attention_bwd_wgmma=MOE_BWD_CALLS_PER_STEP * MOE_TRAIN_STEPS)
    if moe_train_launches != moe_train_want:
        raise SystemExit(f"olmoe training launches {moe_train_launches} != {moe_train_want}")

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mts.train(2)
            torch.cuda.synchronize()
            span = time.perf_counter() - t0
        emit_profile(prof, "moe_train_profile", span, steps=2)
        del prof
    del mtrep

    # -- 13f. the olmoe training checkpoint: bf16 leaves at full width --------
    # A saves at its step (Session.save), then trains MOE_CKPT_STEPS more; B,
    # drawn from another seed, restores it and trains as many: B's losses and
    # every leaf equal A's bit for bit. A's run restarted at the save is the
    # reference: at bf16 compute a row retrieved afresh is rounded to bf16,
    # where one buffer_sync carries over keeps its f32 update, so no run that
    # starts at the save step has the bits of one that runs through it.
    # A's final state waits on the host while B trains.
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    CKPT_DIR.mkdir(parents=True)
    mts.ckpt_dir = str(CKPT_DIR)
    mneed = sum(t.numel() * t.element_size() for _, t in flatten_state(mts.state))
    mfree = shutil.disk_usage(CKPT_DIR).free
    if mfree < 1.05 * mneed:
        raise SystemExit(f"{CKPT_DIR} has {mfree} bytes free; one olmoe checkpoint and "
                         f"5% need {1.05 * mneed:.0f}")
    ckpt_io.clear()
    session_mod.save_checkpoint = timed_io("save", real_io["save_checkpoint"])
    try:
        msaved = mts.save()
    finally:
        session_mod.save_checkpoint = real_io["save_checkpoint"]
    msave_step = int(mts.state.step)
    mck_bytes = sum(f.stat().st_size for f in Path(msaved).iterdir())
    mmanifest = json.loads((Path(msaved) / "manifest.json").read_text())
    mbf16 = sum(e["dtype"] == "bfloat16" for e in mmanifest["leaves"])
    ma_rep = mts.train(MOE_CKPT_STEPS)
    torch.cuda.synchronize()
    ma_losses = ma_rep.stats.losses
    ma_final = [(k, t.cpu()) for k, t in flatten_state(mts.state)]
    del mts, ma_rep, mtwl
    gc.collect()
    torch.cuda.empty_cache()
    after_a_gb = torch.cuda.memory_allocated() / 1e9

    mb = moe_train_session(1, ckpt_dir=str(CKPT_DIR))
    session_mod.restore_latest_verifiable = timed_io(
        "restore", real_io["restore_latest_verifiable"])
    try:
        mrestored = mb.restore_if_available()
    finally:
        session_mod.restore_latest_verifiable = real_io["restore_latest_verifiable"]
    if mrestored != msave_step or int(mb.state.step) != msave_step:
        raise SystemExit(f"the olmoe restore gave step {mrestored}, not {msave_step}")
    torch.cuda.synchronize()
    reset_counts()
    mb_rep = mb.train(MOE_CKPT_STEPS)
    torch.cuda.synchronize()
    moe_ckpt_launches = counts()
    mb_final = flatten_state(mb.state)
    msame = {"losses": mb_rep.stats.losses == ma_losses,
             "leaves": [k for k, _ in mb_final] == [k for k, _ in ma_final]
             and all(torch.equal(t.cpu(), u) for (_, t), (_, u) in zip(mb_final, ma_final))}
    msave, mrestore = ckpt_io["save"], ckpt_io["restore"]
    emit("moe_checkpoint", arch=MOE_ARCH, layers=MOE_TRAIN_LAYERS, saved_at=msave_step,
         steps_after=MOE_CKPT_STEPS, dir=str(CKPT_DIR), free_bytes=mfree,
         checkpoint_bytes=mck_bytes, checkpoint_gb=mck_bytes / 1e9,
         leaves=len(mmanifest["leaves"]), bf16_leaves=mbf16,
         save_s=msave["seconds"], save_d2h_s=msave.get("d2h_s", 0.0),
         save_write_crc_s=msave.get("write_s", 0.0),
         save_gb_per_s=mck_bytes / msave["seconds"] / 1e9,
         save_peak_device_gb=msave["peak_device_gb"],
         restore_s=mrestore["seconds"], restore_verify_s=mrestore["verify_s"],
         restore_load_h2d_s=mrestore["load_s"],
         restore_gb_per_s=mck_bytes / mrestore["seconds"] / 1e9,
         restore_peak_device_gb=mrestore["peak_device_gb"],
         device_gb_after_a=after_a_gb, a_losses=ma_losses, b_losses=mb_rep.stats.losses,
         b_step_ms=[x * 1e3 for x in mb_rep.stats.step_times], bit_equal=msame,
         launches=moe_ckpt_launches)
    if not all(msame.values()):
        raise SystemExit(f"the resumed olmoe run differs from A's: {msame}")
    if not mbf16 or not all(np.isfinite(ma_losses)):
        raise SystemExit(f"the olmoe checkpoint holds {mbf16} bf16 leaves; losses {ma_losses}")
    moe_ckpt_want = {k: 0 for k in KERNELS}
    moe_ckpt_want.update(embedding_gather=(1 + 3 * N_MICRO) * MOE_CKPT_STEPS,
                         segment_rowsum=(N_MICRO + 1) * MOE_CKPT_STEPS,
                         buffer_sync=MOE_CKPT_STEPS - 1, embedding_scatter=MOE_CKPT_STEPS,
                         flash_attention_wgmma=MOE_FWD_CALLS_PER_STEP * MOE_CKPT_STEPS,
                         flash_attention_bwd_wgmma=MOE_BWD_CALLS_PER_STEP * MOE_CKPT_STEPS)
    if moe_ckpt_launches != moe_ckpt_want:
        raise SystemExit(f"resumed olmoe launches {moe_ckpt_launches} != {moe_ckpt_want}")
    del mb, mb_rep, mb_final, ma_final
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(CKPT_DIR)

    # the captured hd-128 attention calls, the session released
    moe_attn = train_attention_rows("moe_train", mtkept, flush, MOE_TRAIN_LAYERS - 1)
    del mtkept, flush
    gc.collect()
    torch.cuda.empty_cache()
    emit("moe_train_phase", seconds=time.perf_counter() - t_phase)

    # -- 13g. MoE consistency ---------------------------------------------------
    t_phase = time.perf_counter()
    moe_runs = {"adam_eps_1e-6": reduced_gaps(adam_eps=1e-6, arch=MOE_ARCH),
                "default_step_sizes": reduced_gaps(arch=MOE_ARCH)}
    # a 2-layer bf16 olmoe at its own head dim (2 heads of 128, 8 experts
    # top-2) on the card and on the CPU from one state
    mred = get_arch(MOE_ARCH).reduced
    mbcfg = dataclasses.replace(mred, name="olmoe-bf16-hd128", d_model=256, d_ff=128,
                                param_dtype="bfloat16", compute_dtype="bfloat16",
                                attention=dataclasses.replace(mred.attention, n_heads=2,
                                                              n_kv_heads=2, head_dim=128))
    mbarch = ArchSpec(mbcfg.name, "lm", mbcfg, mbcfg)
    bkw = dict(global_batch=8, seq_len=200, t_chunk=64)
    mbgpu = Session.from_workload(assemble_workload(mbarch, mbcfg, device=dev, **bkw), seed=3)
    mbcpu = Session.from_workload(assemble_workload(mbarch, mbcfg, device="cpu", **bkw), seed=3)
    mbcpu.state = clone_state(mbgpu.state, "cpu")
    reset_counts()
    mbgot, mbwant = mbgpu.train(3), mbcpu.train(3)
    mbf16_launches = {k: v for k, v in counts().items() if v}
    mbf16_gap = [abs(a - b) / abs(b) for a, b in zip(mbgot.stats.losses, mbwant.stats.losses)]

    # one full-width MoE layer (a training micro-batch: 2 x 4,096 tokens of
    # 2,048, 64 experts top-8, bf16, the router cast to bf16 as in the model)
    # forward and backward twice on one input: the same bits; and its parts
    # timed (routing and the slot plan; the dispatch gather; the experts'
    # products; the combine)
    fcfg = get_arch(MOE_ARCH).config
    gen = torch.Generator(dev).manual_seed(5)
    lp = mlayers.init_moe(fcfg.d_model, fcfg.d_ff, fcfg.moe, fcfg.mlp_type,
                          dtype=torch.bfloat16, device=dev, generator=gen)
    lp["router"] = lp["router"].to(torch.bfloat16)
    lp = {k: v.requires_grad_() for k, v in lp.items()}
    lx = torch.empty((2, LM_TRAIN_SEQ, fcfg.d_model), device=dev).normal_(
        generator=gen).to(torch.bfloat16).requires_grad_()
    lc = torch.empty(lx.shape, device=dev).normal_(generator=gen).to(torch.bfloat16)

    def moe_layer_once():
        out, aux = mlayers.apply_moe(lp, lx, fcfg.moe, fcfg.mlp_type, fcfg.activation)
        grads = torch.autograd.grad((out.float() * lc.float()).sum() + aux,
                                    [lx, *lp.values()])
        return [out.detach(), aux.detach(), *grads]

    first_run, second_run = moe_layer_once(), moe_layer_once()
    layer_same = [torch.equal(a_, b_) for a_, b_ in zip(first_run, second_run)]
    del first_run, second_run
    n_tok = lx.shape[0] * lx.shape[1]
    cap = mlayers.moe_capacity(n_tok, fcfg.moe)
    with torch.no_grad():
        xt = lx.detach().reshape(-1, fcfg.d_model)
        logits = mlayers._router_logits(lp, xt)
        ids, w = mlayers._topk_routing(logits, fcfg.moe.top_k)
        slots = mlayers.moe_slots(ids, w, fcfg.moe.num_experts, cap)
        xe = mlayers._dispatch(xt, slots).reshape(fcfg.moe.num_experts, cap, -1)
        ye = mlayers._experts(lp, xe, fcfg.mlp_type, fcfg.activation).reshape(-1, fcfg.d_model)
        flush = torch.empty(128 * 2 ** 20 // 4, device=dev)
        wparams = {k: v.detach() for k, v in lp.items()}

        def routing():
            lg = mlayers._router_logits(wparams, xt)
            i_, w_ = mlayers._topk_routing(lg, fcfg.moe.top_k)
            mlayers.moe_slots(i_, w_, fcfg.moe.num_experts, cap)

        parts_ms = {
            "routing_and_slots": time_ms(torch, routing, flush),
            "dispatch_gather": time_ms(torch, lambda: mlayers._dispatch(xt, slots), flush),
            "experts": time_ms(torch, lambda: mlayers._experts(wparams, xe, fcfg.mlp_type,
                                                               fcfg.activation), flush),
            "combine": time_ms(torch, lambda: mlayers._combine(ye, slots), flush),
            "forward": time_ms(torch, lambda: mlayers.apply_moe(
                wparams, lx.detach(), fcfg.moe, fcfg.mlp_type, fcfg.activation), flush)}
        expert_ops = 2 * 3 * fcfg.moe.num_experts * cap * fcfg.d_model * fcfg.d_ff
        del logits, ids, w, slots, xe, ye, flush, wparams
    parts_ms["forward_and_backward"] = time_ms(torch, moe_layer_once, torch.empty(
        128 * 2 ** 20 // 4, device=dev))
    emit("moe_consistency", arch=f"{MOE_ARCH} (reduced)", steps=CONSISTENCY_STEPS,
         **moe_runs,
         bf16_hd128={"config": "2 layers, 2 heads of 128, d_model 256, 8 experts top-2, bf16",
                     "losses_card": mbgot.stats.losses, "losses_cpu": mbwant.stats.losses,
                     "moe_aux_card": mbgot.stats.moe_aux, "moe_aux_cpu": mbwant.stats.moe_aux,
                     "relative_gap": mbf16_gap, "bound": LM_BF16_LOSS_RTOL,
                     "launches": mbf16_launches},
         full_width_layer={"tokens": n_tok, "capacity": cap,
                           "same_bits_twice": dict(zip(
                               ["out", "aux", "dx", *(f"d{k}" for k in lp)], layer_same)),
                           "ms": parts_ms, "experts_bf16_bound_ms":
                               expert_ops / bf16_flops(name) * 1e3,
                           "experts_tflops": expert_ops / parts_ms["experts"] / 1e9},
         seconds=time.perf_counter() - t_phase,
         bounds="nestpipe within 1e-5 of the reference, serial within 1e-5 of the "
                "reference on its own (unclustered) micro-batches, async more than 1e-6 "
                f"from the reference; the bf16 config's losses within {LM_BF16_LOSS_RTOL} "
                "of the CPU's; the full-width layer's outputs and gradients the same "
                "bits twice")
    for label, run in moe_runs.items():
        if not run["reference_same_bits_twice"]:
            raise SystemExit(f"the MoE reference gave other bits on a second run ({label})")
        mgaps = run["max_diff_to_reference"]
        for key in ("nestpipe", "serial"):
            if mgaps[key]["rows_dense"] > 1e-5 or mgaps[key]["accum_abs"] > 1e-5:
                raise SystemExit(f"MoE {key} differs from its reference ({label}): {mgaps}")
        if mgaps["async"]["rows_dense"] <= 1e-6:
            raise SystemExit(f"MoE async did not diverge ({label}): {mgaps}")
    if mbf16_launches.get("flash_attention_wgmma", 0) != 2 * 2 * N_MICRO * 3 \
            or mbf16_launches.get("flash_attention_bwd_wgmma", 0) != 2 * N_MICRO * 3 \
            or mbf16_launches.get("flash_attention_bwd_simple", 0) != 0:
        raise SystemExit(f"the bf16 hd-128 MoE config launched {mbf16_launches}")
    if not all(np.isfinite(mbgot.stats.losses)) or max(mbf16_gap) > LM_BF16_LOSS_RTOL:
        raise SystemExit(f"the bf16 MoE losses on the card are {mbf16_gap} from the CPU's")
    if not all(layer_same):
        raise SystemExit(f"the full-width MoE layer gave other bits on a second run: "
                         f"{layer_same}")
    del mbgpu, mbcpu, mbgot, mbwant, lp, lx, lc, xt
    gc.collect()
    torch.cuda.empty_cache()

    # -- 13h. main path: full-width mamba2-370m serving -------------------------
    # every width and all 48 layers through Session.from_arch, at 13's shape:
    # the same tokens twice, the launches counted (the gathers alone: the
    # Mamba mixer runs no kernel of its own), a prefill of T and one decode
    # step against a prefill of T + 1 (the conv and ssm states carried),
    # layer 0's SSD call against the f64 recurrence, its share of the layer
    t_phase = time.perf_counter()
    start_gb = torch.cuda.memory_allocated() / 1e9
    ssess = Session.from_arch(MAMBA_ARCH, seed=0)
    swl, scfg = ssess.workload, ssess.workload.cfg
    sm = scfg.mamba
    if (scfg.n_layers, scfg.d_model, scfg.vocab_size, sm.d_state, sm.headdim, sm.expand,
            sm.chunk_size) != (48, 1024, 50288, 128, 64, 2, 256):
        raise SystemExit(f"{MAMBA_ARCH} is not at its published widths")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sparams, stable = ssess.lm_weights()
    torch.cuda.synchronize()
    sdraw_s = time.perf_counter() - t0
    sweights_gb = sum(p_.numel() * p_.element_size() for p_ in sparams.values()) / 1e9
    kept_ssd, kept_block, ssd_calls = {}, {}, [0]
    real_ssd, real_block = mmamba.ssd_chunked, mtransformer._block

    def ssd_spy(x, dt, A, Bm, Cm, chunk, init_state=None):
        if ssd_calls[0] == 0:  # layer 0 of the prefill
            kept_ssd["args"] = (x.clone(), dt.clone(), A.clone(), Bm.clone(), Cm.clone(),
                                chunk)
        ssd_calls[0] += 1
        return real_ssd(x, dt, A, Bm, Cm, chunk, init_state)

    def block_spy(lp, cfg_, mixer, ffn, x, positions):
        if not kept_block:
            kept_block["args"] = (lp, mixer, ffn, x.clone(), positions)
        return real_block(lp, cfg_, mixer, ffn, x, positions)

    mmamba.ssd_chunked, mtransformer._block = ssd_spy, block_spy
    try:
        t0 = time.perf_counter()
        swarm, skept, sn_gathers = serve_keeping_gathers(
            stable, lambda: ssess.serve(batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN))
        torch.cuda.synchronize()
        swarm_s = time.perf_counter() - t0
    finally:
        mmamba.ssd_chunked, mtransformer._block = real_ssd, real_block
    if ssd_calls[0] != scfg.n_layers * (1 + decode_steps):
        raise SystemExit(f"the warm-up mamba serve made {ssd_calls[0]} SSD calls")
    # its gathers at their shapes (1,024-wide f32 master rows, then bf16)
    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)  # evicts the L2 (time_ms)
    mamba_gathers = check_serve_gathers("mamba_serve", skept, sn_gathers, 1 + decode_steps,
                                        stable)
    del skept
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    srep = ssess.serve(batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN)
    torch.cuda.synchronize()
    mamba_serve_launches = counts()
    mamba_serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ss_ = srep.summary
    emit("mamba_serve", arch=MAMBA_ARCH, batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN,
         reduced="batch 8, prompt 2048, 32 generated; every width, all 48 layers",
         config={k: getattr(scfg, k) for k in ("n_layers", "d_model", "vocab_size",
                                               "param_dtype", "compute_dtype")},
         mamba=dataclasses.asdict(sm), params=scfg.param_count(),
         weights_gb=sweights_gb, table_gb=stable.rows.numel() * 4 / 1e9,
         prefill_s=ss_["prefill_s"], prompt_tokens_per_s=LM_BATCH * LM_PROMPT / ss_["prefill_s"],
         decode_s=ss_["decode_s"], decode_step_ms=ss_["decode_s"] / decode_steps * 1e3,
         generated_tokens_per_s=ss_["tokens_per_s"], weights_draw_s=sdraw_s,
         warmup_serve_s=swarm_s, launches=mamba_serve_launches,
         max_memory_allocated_gb=mamba_serve_peak_gb, start_memory_allocated_gb=start_gb,
         sample_tokens=ss_["sample_tokens"])
    mamba_serve_want = {k: 0 for k in KERNELS}
    mamba_serve_want.update(embedding_gather=3 * (1 + decode_steps))
    if mamba_serve_launches != mamba_serve_want:
        raise SystemExit(f"mamba serving launches {mamba_serve_launches} != {mamba_serve_want}")
    if not np.array_equal(srep.tokens, swarm.tokens):
        raise SystemExit("two mamba serves of the same weights generated different tokens")
    if srep.tokens.shape != (LM_BATCH, LM_GEN) or not (
            (0 <= srep.tokens) & (srep.tokens < scfg.vocab_size)).all():
        raise SystemExit(f"mamba tokens {srep.tokens.shape} are not vocabulary ids")

    def prefill_plus_decode(sess, params, table, label, batch=LM_BATCH, prompt=LM_PROMPT,
                            extras=None, prefix=None):
        """A prefill of ``prompt`` tokens and one decode step against a
        prefill of ``prompt`` + 1 (the same prompts; an encoder-decoder's
        same frames in ``extras``; a VLM's patches, ``prefix``, ahead of
        both): the last-token logits within LM_LOGIT_RTOL of max |logit|
        (the caches' states carried)."""
        cfg_ = sess.workload.cfg
        extras = extras or {}
        toks = np.random.default_rng(sess.seed).integers(0, cfg_.vocab_size,
                                                         size=(batch, prompt + 1))
        with torch.inference_mode():
            keys = sess.workload.spec.scramble(torch.as_tensor(toks.astype(np.int32),
                                                               device=dev))
            emb, _ = sess.workload.engine.lookup_from_master(table, keys)
            if prefix is not None:
                emb = torch.cat([prefix.to(emb.dtype), emb], dim=1)
            t_ = emb.shape[1] - 1
            _, cache = sess.workload.bundle.prefill(params, emb[:, :t_],
                                                   cache_len=t_ + 1, **extras)
            step, cache = sess.workload.bundle.decode_step(params, emb[:, t_:], cache)
            del cache
            whole, cache = sess.workload.bundle.prefill(params, emb, **extras)
            del cache, emb
        scale_ = float(whole.abs().max())
        gap = float((step - whole).abs().max())
        out = {"max_abs_logit": scale_, "max_logit_gap": gap, "gap_share": gap / scale_,
               "bound_share": LM_LOGIT_RTOL,
               "greedy_tokens_agreeing": float((step.argmax(-1) == whole.argmax(-1))
                                               .float().mean())}
        emit(f"{label}_prefill_plus_decode", **out)
        if not np.isfinite(step.cpu().numpy()).all() or gap > LM_LOGIT_RTOL * scale_:
            raise SystemExit(f"{label}: a prefill and a decode step are {gap} from the "
                             f"longer prefill (max |logit| {scale_})")
        return out

    prefill_plus_decode(ssess, sparams, stable, "mamba")

    # layer 0's SSD call (f32, TF32 off) against the f64 recurrence on the
    # same inputs, and its device time beside the layer's forward
    with torch.inference_mode():
        x_, dt_, A_, B_, C_, chunk_ = kept_ssd["args"]
        y_, s_ = real_ssd(x_, dt_, A_, B_, C_, chunk_)
        ry, rs = mmamba.ssd_reference(x_, dt_, A_, B_, C_, dtype=torch.float64)
        ssd_err = float((y_.double() - ry).abs().max())
        ssd_scale = float(ry.abs().max())
        state_err = float((s_.double() - rs).abs().max()) / float(rs.abs().max())
        del y_, s_, ry, rs
        lp_, mixer_, ffn_, xin_, pos_ = kept_block["args"]
        ssd_ms = time_ms(torch, lambda: real_ssd(x_, dt_, A_, B_, C_, chunk_), flush)
        layer_ms = time_ms(torch, lambda: real_block(lp_, scfg, mixer_, ffn_, xin_, pos_),
                           flush)
        mixer_ms = time_ms(torch, lambda: mmamba.mamba_mixer(lp_["mamba"], xin_, sm)[0], flush)
    emit("mamba_ssd", call="prefill layer 0", shape={"x": list(x_.shape), "B": list(B_.shape)},
         dtypes={"x": str(x_.dtype), "dt": str(dt_.dtype), "A": str(A_.dtype)},
         chunk=chunk_, max_abs_err=ssd_err, max_abs_y=ssd_scale, err_share=ssd_err / ssd_scale,
         final_state_err_share=state_err, bound_share=MAMBA_SSD_RTOL,
         ssd_ms=ssd_ms, mixer_ms=mixer_ms, layer_ms=layer_ms,
         ssd_share_of_layer=ssd_ms / layer_ms,
         reference="ssd_reference in f64 on the card, one step a position")
    if not ssd_err <= MAMBA_SSD_RTOL * ssd_scale or not state_err <= MAMBA_SSD_RTOL:
        raise SystemExit(f"layer 0's chunked SSD is {ssd_err} from the f64 recurrence "
                         f"(max |y| {ssd_scale}; state {state_err})")
    del kept_ssd, kept_block, x_, dt_, A_, B_, C_, lp_, xin_, pos_

    if args.profile:  # the prefill, then 8 decode steps from its cache
        from torch.profiler import ProfilerActivity, profile

        toks = np.random.default_rng(ssess.seed).integers(0, scfg.vocab_size,
                                                          size=(LM_BATCH, LM_PROMPT))
        with torch.inference_mode():
            skeys = swl.spec.scramble(torch.as_tensor(toks.astype(np.int32), device=dev))
            emb, _ = swl.engine.lookup_from_master(stable, skeys)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                logits, cache = swl.bundle.prefill(sparams, emb, cache_len=LM_PROMPT + LM_GEN)
                tok = logits.argmax(-1).to(torch.int32)
                torch.cuda.synchronize()
                span = time.perf_counter() - t0
            emit_profile(prof, "mamba_prefill_profile", span, prefills=1)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(8):
                    emb, _ = swl.engine.lookup_from_master(stable, swl.spec.scramble(tok[:, None]))
                    logits, cache = swl.bundle.decode_step(sparams, emb, cache)
                    tok = logits.argmax(-1).to(torch.int32)
                    tok.cpu()  # as serve() reads each token back
                torch.cuda.synchronize()
                span = time.perf_counter() - t0
            emit_profile(prof, "mamba_decode_profile", span, steps=8)
            del prof, logits, cache, emb
    del ssess, swl, sparams, stable, swarm, srep, flush
    gc.collect()
    torch.cuda.empty_cache()
    emit("mamba_serve_phase", seconds=time.perf_counter() - t_phase)

    # -- 13i. main path: full-width mamba2-370m training, all 48 layers ---------
    t_phase = time.perf_counter()
    start_gb = torch.cuda.memory_allocated() / 1e9
    msess = Session.from_arch(MAMBA_ARCH, mode="nestpipe", global_batch=LM_TRAIN_BATCH,
                              seq_len=LM_TRAIN_SEQ, n_micro=N_MICRO, lr=LM_TRAIN_LR, seed=0)
    mwl_ = msess.workload
    sdims = mwl_.engine.dims(mwl_.batch_shapes["keys"][0][1:], N_MICRO)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sstate = msess.state
    torch.cuda.synchronize()
    s_params = sum(p_.numel() for p_ in sstate.dense.values())
    emit("mamba_train_init", arch=MAMBA_ARCH, seconds=time.perf_counter() - t0,
         dense_params=s_params,
         params_gb=sum(p_.numel() * p_.element_size() for p_ in sstate.dense.values()) / 1e9,
         moments_gb=2 * 4 * s_params / 1e9, table_gb=sstate.table.rows.numel() * 4 / 1e9,
         dims={"L": sdims.l_local, "U": sdims.u_max, "C": sdims.cap, "K": sdims.buffer_cap,
               "N": sdims.n_micro},
         ssd_chunk_tensor_gb=(LM_TRAIN_SEQ // sm.chunk_size) * (LM_TRAIN_BATCH // N_MICRO)
         * (sm.expand * scfg.d_model // sm.headdim) * sm.chunk_size ** 2 * 4 / 1e9,
         start_memory_allocated_gb=start_gb,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    if sstate.dense["blocks.0.mamba.wz"].shape != (48, 1024, 2048) \
            or sstate.table.rows.shape[1] != 1024 or sstate.table.rows.device.type != "cuda":
        raise SystemExit(f"{MAMBA_ARCH} training is not at full width on the card")
    del sstate
    sfirst_loss = msess.train(1).stats.losses[0]
    torch.cuda.synchronize()
    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)  # evicts the L2 (time_ms)
    scaptured = capture_calls(msess)
    sshapes = check_and_time("mamba_train", scaptured, msess.state.table)
    del scaptured
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    strep = msess.train(LM_TRAIN_STEPS)
    torch.cuda.synchronize()
    swall = time.perf_counter() - t0
    mamba_train_launches = counts()
    mamba_train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    s = strep.summary
    ssamples_per_s = LM_TRAIN_BATCH * LM_TRAIN_STEPS / swall
    emit("mamba_train", arch=MAMBA_ARCH, mode="nestpipe", global_batch=LM_TRAIN_BATCH,
         seq_len=LM_TRAIN_SEQ, n_micro=N_MICRO, steps=LM_TRAIN_STEPS, lr=LM_TRAIN_LR,
         reduced="depth and widths whole; batch 8 of train_4k's 256 (one of 32 workers)",
         first_loss=sfirst_loss, losses=strep.stats.losses, overflow_max=s["overflow_max"],
         samples_per_s=ssamples_per_s, tokens_per_s=ssamples_per_s * LM_TRAIN_SEQ,
         wall_s=swall, step_ms=[x * 1e3 for x in strep.stats.step_times],
         step_p50_ms=s["p50_step_s"] * 1e3, step_p99_ms=s["p99_step_s"] * 1e3,
         mean_input_wait_ms=s["mean_input_wait_s"] * 1e3,
         stage_host_ms={k: s[k] for k in ("plan_ms", "retrieve_ms", "commit_ms")},
         launches=mamba_train_launches, max_memory_allocated_gb=mamba_train_peak_gb,
         device_memory_gb=torch.cuda.get_device_properties(0).total_memory / 1e9)
    if not all(np.isfinite(strep.stats.losses)) or len(strep.stats.losses) != LM_TRAIN_STEPS:
        raise SystemExit(f"mamba losses are not {LM_TRAIN_STEPS} finite values")
    if not all(x < sfirst_loss for x in strep.stats.losses):
        raise SystemExit(f"the mamba loss did not fall from {sfirst_loss}: "
                         f"{strep.stats.losses}")
    if s["overflow_max"] != 0:
        raise SystemExit(f"mamba routing overflowed: {s['overflow_max']}")
    if mamba_train_peak_gb >= 80:
        raise SystemExit(f"mamba training peaked at {mamba_train_peak_gb} GB")
    mamba_train_want = {k: 0 for k in KERNELS}
    mamba_train_want.update(embedding_gather=(1 + 3 * N_MICRO) * LM_TRAIN_STEPS,
                            segment_rowsum=(N_MICRO + 1) * LM_TRAIN_STEPS,
                            buffer_sync=LM_TRAIN_STEPS - 1, embedding_scatter=LM_TRAIN_STEPS)
    if mamba_train_launches != mamba_train_want:
        raise SystemExit(f"mamba training launches {mamba_train_launches} != "
                         f"{mamba_train_want}")
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            msess.train(2)
            torch.cuda.synchronize()
            span = time.perf_counter() - t0
        emit_profile(prof, "mamba_train_profile", span, steps=2)
        del prof
    del msess, mwl_, strep, flush
    gc.collect()
    torch.cuda.empty_cache()

    # consistency: mamba2-370m-reduced nestpipe = serial = the reference, and
    # a 2-layer mamba2-370m at every width (f32 params, bf16 compute, one
    # chunk of 256 and a padded second) on the card and on the CPU from one
    # state
    mamba_runs = {"adam_eps_1e-6": reduced_gaps(adam_eps=1e-6, arch=MAMBA_ARCH),
                  "default_step_sizes": reduced_gaps(arch=MAMBA_ARCH)}
    m2cfg = dataclasses.replace(get_arch(MAMBA_ARCH).config, name="mamba2-370m-2-layers",
                                n_layers=2)
    m2arch = ArchSpec(m2cfg.name, "lm", m2cfg, m2cfg)
    m2kw = dict(global_batch=8, seq_len=320, t_chunk=64)
    m2gpu = Session.from_workload(assemble_workload(m2arch, m2cfg, device=dev, **m2kw), seed=3)
    m2cpu = Session.from_workload(assemble_workload(m2arch, m2cfg, device="cpu", **m2kw),
                                  seed=3)
    m2cpu.state = clone_state(m2gpu.state, "cpu")
    reset_counts()
    m2got, m2want = m2gpu.train(3), m2cpu.train(3)
    m2_launches = {k: v for k, v in counts().items() if v}
    m2_gap = [abs(a - b) / abs(b) for a, b in zip(m2got.stats.losses, m2want.stats.losses)]
    emit("mamba_consistency", arch=f"{MAMBA_ARCH} (reduced)", steps=CONSISTENCY_STEPS,
         **mamba_runs, two_layers_full_width={
             "config": "2 layers at every width, f32 params, bf16 compute, 8 x 320 tokens",
             "losses_card": m2got.stats.losses, "losses_cpu": m2want.stats.losses,
             "relative_gap": m2_gap, "bound": LM_BF16_LOSS_RTOL, "launches": m2_launches},
         seconds=time.perf_counter() - t_phase,
         bounds="rows, dense and accum within 1e-5 at AdamW eps 1e-6 and at the default "
                "eps; async more than 1e-6 from the reference; the 2-layer losses within "
                f"{LM_BF16_LOSS_RTOL} of the CPU's")
    for label, run in mamba_runs.items():
        if not run["reference_same_bits_twice"]:
            raise SystemExit(f"the mamba reference gave other bits on a second run ({label})")
        sgaps = run["max_diff_to_reference"]
        for key in ("nestpipe", "serial", "nestpipe_vs_serial"):
            if sgaps[key]["rows_dense"] > 1e-5 or sgaps[key]["accum_abs"] > 1e-5:
                raise SystemExit(f"mamba {key} differs from the reference ({label}): {sgaps}")
        if sgaps["async"]["rows_dense"] <= 1e-6:
            raise SystemExit(f"mamba async did not diverge ({label}): {sgaps}")
    if not all(np.isfinite(m2got.stats.losses)) or max(m2_gap) > LM_BF16_LOSS_RTOL:
        raise SystemExit(f"the 2-layer mamba losses on the card are {m2_gap} from the CPU's")
    del m2gpu, m2cpu, m2got, m2want
    gc.collect()
    torch.cuda.empty_cache()
    emit("mamba_train_phase", seconds=time.perf_counter() - t_phase)

    # -- 13j. main path: jamba-v0.1-52b served at every width, 8 of 32 layers --
    # one period of its pattern (Mamba, MoE at the odd offsets, attention at
    # offset 4) through the build path, served at 13's shape: one wgmma
    # forward at hd 128 a serve, the same tokens twice, the prefill against
    # the plain attention's, a prefill and a decode step against the longer
    # prefill
    t_phase = time.perf_counter()
    start_gb = torch.cuda.memory_allocated() / 1e9
    jcfg = dataclasses.replace(get_arch(JAMBA_ARCH).config, n_layers=JAMBA_SERVE_LAYERS)
    jsess = Session.from_workload(assemble_workload(
        ArchSpec(JAMBA_ARCH, "lm", jcfg, jcfg), jcfg, device=dev), seed=0)
    ja, jm_, jmo = jcfg.attention, jcfg.mamba, jcfg.moe
    if (jcfg.d_model, jcfg.d_ff, jcfg.vocab_size, ja.n_heads, ja.n_kv_heads, ja.head_dim,
            jmo.num_experts, jmo.top_k, jm_.d_state, jm_.headdim) != (
                4096, 14336, 65536, 32, 8, 128, 16, 2, 16, 64) \
            or [mx for mx, _ in jcfg.layer_plan].count("attn") != 1:
        raise SystemExit(f"{JAMBA_ARCH} is not at its published widths")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    jparams, jtable = jsess.lm_weights()
    torch.cuda.synchronize()
    jdraw_s = time.perf_counter() - t0
    jweights_gb = sum(p_.numel() * p_.element_size() for p_ in jparams.values()) / 1e9
    kept_jflash, jflash_calls = {}, [0]

    def jflash_spy(q, k, v, causal=True):
        if jflash_calls[0] == 0:
            kept_jflash[4] = (q.clone(), k.clone(), v.clone(), causal)
        jflash_calls[0] += 1
        return real_flash(q, k, v, causal)

    dispatch.flash_attention = jflash_spy
    try:
        t0 = time.perf_counter()
        jwarm, jkept, jn_gathers = serve_keeping_gathers(
            jtable, lambda: jsess.serve(batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN))
        torch.cuda.synchronize()
        jwarm_s = time.perf_counter() - t0
    finally:
        dispatch.flash_attention = real_flash
    if jflash_calls[0] != 1:
        raise SystemExit(f"the warm-up jamba serve made {jflash_calls[0]} flash calls")
    # its gathers at their shapes (4,096-wide f32 master rows, then bf16)
    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)  # evicts the L2 (time_ms)
    jamba_gathers = check_serve_gathers("jamba_serve", jkept, jn_gathers, 1 + decode_steps,
                                        jtable)
    del jkept, flush
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    jrep = jsess.serve(batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN)
    torch.cuda.synchronize()
    jamba_serve_launches = counts()
    jamba_serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    js_ = jrep.summary
    emit("jamba_serve", arch=JAMBA_ARCH, layers=JAMBA_SERVE_LAYERS, batch=LM_BATCH,
         prompt_len=LM_PROMPT, gen=LM_GEN,
         reduced=f"every width, the first {JAMBA_SERVE_LAYERS} of 32 layers (one period); "
                 "batch 8, prompt 2048, 32 generated",
         layer_plan=[list(x) for x in jcfg.layer_plan], params=jcfg.param_count(),
         full_params=get_arch(JAMBA_ARCH).config.param_count(),
         heads=[ja.n_heads, ja.n_kv_heads, ja.head_dim],
         experts=[jmo.num_experts, jmo.top_k, jmo.capacity_factor],
         mamba=dataclasses.asdict(jm_),
         ssd_chunk_tensor_gb=(LM_PROMPT // jm_.chunk_size) * LM_BATCH
         * (jm_.expand * jcfg.d_model // jm_.headdim) * jm_.chunk_size ** 2 * 4 / 1e9,
         weights_gb=jweights_gb, table_gb=jtable.rows.numel() * 4 / 1e9,
         prefill_s=js_["prefill_s"], prompt_tokens_per_s=LM_BATCH * LM_PROMPT / js_["prefill_s"],
         decode_s=js_["decode_s"], decode_step_ms=js_["decode_s"] / decode_steps * 1e3,
         generated_tokens_per_s=js_["tokens_per_s"], weights_draw_s=jdraw_s,
         warmup_serve_s=jwarm_s, launches=jamba_serve_launches,
         max_memory_allocated_gb=jamba_serve_peak_gb, start_memory_allocated_gb=start_gb,
         sample_tokens=js_["sample_tokens"])
    jamba_serve_want = {k: 0 for k in KERNELS}
    jamba_serve_want.update(embedding_gather=3 * (1 + decode_steps), flash_attention_wgmma=1)
    if jamba_serve_launches != jamba_serve_want:
        raise SystemExit(f"jamba serving launches {jamba_serve_launches} != {jamba_serve_want}")
    if not np.array_equal(jrep.tokens, jwarm.tokens):
        raise SystemExit("two jamba serves of the same weights generated different tokens")
    if jrep.tokens.shape != (LM_BATCH, LM_GEN) or not (
            (0 <= jrep.tokens) & (jrep.tokens < jcfg.vocab_size)).all():
        raise SystemExit(f"jamba tokens {jrep.tokens.shape} are not vocabulary ids")

    # the prefill with the kernel and with the plain attention
    toks = np.random.default_rng(jsess.seed).integers(0, jcfg.vocab_size,
                                                      size=(LM_BATCH, LM_PROMPT))
    with torch.inference_mode():
        jkeys = jsess.workload.spec.scramble(torch.as_tensor(toks.astype(np.int32), device=dev))
        emb, _ = jsess.workload.engine.lookup_from_master(jtable, jkeys)
        logits_k, cache = jsess.workload.bundle.prefill(jparams, emb,
                                                       cache_len=LM_PROMPT + LM_GEN)
        del cache
        dispatch.flash_attention = ref.flash_attention_ref
        try:
            logits_p, cache = jsess.workload.bundle.prefill(jparams, emb,
                                                           cache_len=LM_PROMPT + LM_GEN)
        finally:
            dispatch.flash_attention = real_flash
        del cache, emb, jkeys
    scale = float(logits_p.abs().max())
    logit_gap = float((logits_k - logits_p).abs().max())
    first_tok = logits_k.argmax(-1).cpu().numpy()
    emit("jamba_prefill_vs_plain", max_abs_logit=scale, max_logit_gap=logit_gap,
         gap_share=logit_gap / scale, bound_share=LM_LOGIT_RTOL,
         greedy_tokens_agreeing=float((logits_k.argmax(-1) == logits_p.argmax(-1))
                                      .float().mean()),
         first_token_equals_serve=bool(np.array_equal(first_tok, jrep.tokens[:, 0])))
    if not np.isfinite(logits_k.cpu().numpy()).all() or logit_gap > LM_LOGIT_RTOL * scale:
        raise SystemExit(f"jamba prefill logits with the kernel are {logit_gap} from the "
                         f"plain attention's (max |logit| {scale})")
    if not np.array_equal(first_tok, jrep.tokens[:, 0]):
        raise SystemExit("the jamba prefill's argmax is not the serve's first token")
    del logits_k, logits_p
    prefill_plus_decode(jsess, jparams, jtable, "jamba")
    del jsess, jparams, jtable, jwarm, jrep
    gc.collect()
    torch.cuda.empty_cache()
    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)  # evicts the L2 (time_ms)
    jfrows = prefill_flash_rows("jamba_serve", kept_jflash, flush)
    del kept_jflash, flush
    gc.collect()
    torch.cuda.empty_cache()
    emit("jamba_serve_phase", seconds=time.perf_counter() - t_phase)

    # -- 13k. main path: full-width whisper-base serving ------------------------
    # every width and all 6 + 6 layers through Session.from_arch: 18 wgmma
    # forwards a serve at hd 64 (6 encoder calls without a mask at T 1,500, 6
    # causal decoder calls, 6 cross calls of the prompt against the frames),
    # the same tokens twice, the prefill against the plain attention's, a
    # prefill and a decode step against the longer prefill (the self and the
    # memory caches carried), layer 0's three calls checked and timed
    t_phase = time.perf_counter()
    start_gb = torch.cuda.memory_allocated() / 1e9

    def encdec_call_kind(q, k, causal):
        """Which of the encoder-decoder's attentions a call is: the
        decoder's self-attention (causal), the cross attention (Tq != Tk),
        or the encoder's (no mask, Tq = Tk = the frames)."""
        return "decoder" if causal else "cross" if q.shape[1] != k.shape[1] else "encoder"

    wsess = Session.from_arch(WHISPER_ARCH, seed=0)
    wwl, wcfg = wsess.workload, wsess.workload.cfg
    wa_, wenc = wcfg.attention, wcfg.encoder
    if (wcfg.n_layers, wenc.n_layers, wcfg.d_model, wcfg.d_ff, wcfg.vocab_size, wa_.n_heads,
            wa_.n_kv_heads, wa_.head_dim, wenc.n_frames) != (
                6, 6, 512, 2048, 51872, 8, 8, 64, 1500) or wsess.workload.arch.kind != "encdec":
        raise SystemExit(f"{WHISPER_ARCH} is not at its published widths")
    w_decode_steps = WHISPER_GEN - 1
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wparams, wtable = wsess.lm_weights()
    torch.cuda.synchronize()
    wdraw_s = time.perf_counter() - t0
    wweights_gb = sum(p_.numel() * p_.element_size() for p_ in wparams.values()) / 1e9
    kept_wflash, wflash_calls = {}, [0]

    def wflash_spy(q, k, v, causal=True):
        kind = "0 " + encdec_call_kind(q, k, causal)  # "prefill layer 0 encoder", ...
        if kind not in kept_wflash:  # each kind's first call: layer 0's
            kept_wflash[kind] = (q.clone(), k.clone(), v.clone(), causal)
        wflash_calls[0] += 1
        return real_flash(q, k, v, causal)

    dispatch.flash_attention = wflash_spy
    try:
        t0 = time.perf_counter()
        wwarm, wkept_gather, wn_gathers = serve_keeping_gathers(
            wtable, lambda: wsess.serve(batch=WHISPER_BATCH, prompt_len=WHISPER_PROMPT,
                                        gen=WHISPER_GEN))
        torch.cuda.synchronize()
        wwarm_s = time.perf_counter() - t0
    finally:
        dispatch.flash_attention = real_flash
    if wflash_calls[0] != WHISPER_FWD_CALLS_PER_SERVE or len(kept_wflash) != 3:
        raise SystemExit(f"the warm-up whisper serve made {wflash_calls[0]} flash calls "
                         f"of kinds {sorted(kept_wflash)}")
    # its gathers at their shapes (512-wide f32 master rows, then bf16)
    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)  # evicts the L2 (time_ms)
    whisper_gathers = check_serve_gathers("whisper_serve", wkept_gather, wn_gathers,
                                          1 + w_decode_steps, wtable)
    del wkept_gather
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    wrep = wsess.serve(batch=WHISPER_BATCH, prompt_len=WHISPER_PROMPT, gen=WHISPER_GEN)
    torch.cuda.synchronize()
    whisper_serve_launches = counts()
    whisper_serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ws_ = wrep.summary
    emit("whisper_serve", arch=WHISPER_ARCH, batch=WHISPER_BATCH, prompt_len=WHISPER_PROMPT,
         gen=WHISPER_GEN, frames=wenc.n_frames,
         reduced="none: every width, 6 + 6 layers; batch 16, prompt 416, 32 generated "
                 "(448 positions: Whisper's text context)",
         config={k: getattr(wcfg, k) for k in ("n_layers", "d_model", "d_ff", "vocab_size",
                                               "param_dtype", "compute_dtype")},
         encoder=dataclasses.asdict(wenc), heads=[wa_.n_heads, wa_.n_kv_heads, wa_.head_dim],
         params=wcfg.param_count(), weights_gb=wweights_gb,
         table_gb=wtable.rows.numel() * 4 / 1e9,
         prefill_s=ws_["prefill_s"],
         prompt_tokens_per_s=WHISPER_BATCH * WHISPER_PROMPT / ws_["prefill_s"],
         decode_s=ws_["decode_s"], decode_step_ms=ws_["decode_s"] / w_decode_steps * 1e3,
         generated_tokens_per_s=ws_["tokens_per_s"], weights_draw_s=wdraw_s,
         warmup_serve_s=wwarm_s, launches=whisper_serve_launches,
         max_memory_allocated_gb=whisper_serve_peak_gb, start_memory_allocated_gb=start_gb,
         sample_tokens=ws_["sample_tokens"])
    whisper_serve_want = {k: 0 for k in KERNELS}
    whisper_serve_want.update(embedding_gather=3 * (1 + w_decode_steps),
                              flash_attention_wgmma=WHISPER_FWD_CALLS_PER_SERVE)
    if whisper_serve_launches != whisper_serve_want:
        raise SystemExit(f"whisper serving launches {whisper_serve_launches} != "
                         f"{whisper_serve_want}")
    if not np.array_equal(wrep.tokens, wwarm.tokens):
        raise SystemExit("two whisper serves of the same weights generated different tokens")
    if wrep.tokens.shape != (WHISPER_BATCH, WHISPER_GEN) or not (
            (0 <= wrep.tokens) & (wrep.tokens < wcfg.vocab_size)).all():
        raise SystemExit(f"whisper tokens {wrep.tokens.shape} are not vocabulary ids")

    # the prefill with the kernel and with the plain attention, on the
    # serve's prompts and frames (Session.serve's draw: the prompts, then the
    # frames, from one rng)
    wrng = np.random.default_rng(wsess.seed)
    toks = wrng.integers(0, wcfg.vocab_size, size=(WHISPER_BATCH, WHISPER_PROMPT))
    wframes = torch.as_tensor(wrng.normal(size=(WHISPER_BATCH, wenc.n_frames, wcfg.d_model))
                              .astype(np.float32) * 0.02, device=dev)
    with torch.inference_mode():
        wkeys = wwl.spec.scramble(torch.as_tensor(toks.astype(np.int32), device=dev))
        emb, _ = wwl.engine.lookup_from_master(wtable, wkeys)
        logits_k, cache = wwl.bundle.prefill(wparams, emb, frames=wframes,
                                             cache_len=WHISPER_PROMPT + WHISPER_GEN)
        wcache_gb = sum(x.numel() * x.element_size() for x in cache[:4]) / 1e9
        del cache
        dispatch.flash_attention = ref.flash_attention_ref
        try:
            logits_p, cache = wwl.bundle.prefill(wparams, emb, frames=wframes,
                                                 cache_len=WHISPER_PROMPT + WHISPER_GEN)
        finally:
            dispatch.flash_attention = real_flash
        del cache, emb
    scale = float(logits_p.abs().max())
    logit_gap = float((logits_k - logits_p).abs().max())
    first_tok = logits_k.argmax(-1).cpu().numpy()
    emit("whisper_prefill_vs_plain", max_abs_logit=scale, max_logit_gap=logit_gap,
         gap_share=logit_gap / scale, bound_share=LM_LOGIT_RTOL, cache_gb=wcache_gb,
         greedy_tokens_agreeing=float((logits_k.argmax(-1) == logits_p.argmax(-1))
                                      .float().mean()),
         first_token_equals_serve=bool(np.array_equal(first_tok, wrep.tokens[:, 0])))
    if not np.isfinite(logits_k.cpu().numpy()).all() or logit_gap > LM_LOGIT_RTOL * scale:
        raise SystemExit(f"whisper prefill logits with the kernel are {logit_gap} from the "
                         f"plain attention's (max |logit| {scale})")
    if not np.array_equal(first_tok, wrep.tokens[:, 0]):
        raise SystemExit("the whisper prefill's argmax is not the serve's first token")
    del logits_k, logits_p
    prefill_plus_decode(wsess, wparams, wtable, "whisper", batch=WHISPER_BATCH,
                        prompt=WHISPER_PROMPT, extras={"frames": wframes})

    if args.profile:  # the prefill, then 8 decode steps from its cache
        from torch.profiler import ProfilerActivity, profile

        with torch.inference_mode():
            emb, _ = wwl.engine.lookup_from_master(wtable, wkeys)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                logits, cache = wwl.bundle.prefill(wparams, emb, frames=wframes,
                                                   cache_len=WHISPER_PROMPT + WHISPER_GEN)
                tok = logits.argmax(-1).to(torch.int32)
                torch.cuda.synchronize()
                span = time.perf_counter() - t0
            emit_profile(prof, "whisper_prefill_profile", span, prefills=1)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(8):
                    emb, _ = wwl.engine.lookup_from_master(wtable, wwl.spec.scramble(tok[:, None]))
                    logits, cache = wwl.bundle.decode_step(wparams, emb, cache)
                    tok = logits.argmax(-1).to(torch.int32)
                    tok.cpu()  # as serve() reads each token back
                torch.cuda.synchronize()
                span = time.perf_counter() - t0
            emit_profile(prof, "whisper_decode_profile", span, steps=8)
            del prof, logits, cache, emb
    del wsess, wwl, wparams, wtable, wwarm, wrep, wframes, wkeys
    gc.collect()
    torch.cuda.empty_cache()
    wfrows = prefill_flash_rows("whisper_serve", kept_wflash, flush)
    del kept_wflash, flush
    gc.collect()
    torch.cuda.empty_cache()
    emit("whisper_serve_phase", seconds=time.perf_counter() - t_phase)

    # -- 13l. main path: full-width whisper-base training, all 6 + 6 layers ----
    t_phase = time.perf_counter()
    start_gb = torch.cuda.memory_allocated() / 1e9
    wtsess = Session.from_arch(WHISPER_ARCH, mode="nestpipe", global_batch=WHISPER_TRAIN_BATCH,
                               seq_len=WHISPER_TRAIN_SEQ, n_micro=N_MICRO, bucket_slack=SLACK,
                               lr=LM_TRAIN_LR, seed=0)
    wtwl = wtsess.workload
    wdims = wtwl.engine.dims(wtwl.batch_shapes["keys"][0][1:], N_MICRO)
    frames_shape = wtwl.batch_shapes["frames"][0]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wstate = wtsess.state
    torch.cuda.synchronize()
    w_params = sum(p_.numel() for p_ in wstate.dense.values())
    emit("whisper_train_init", arch=WHISPER_ARCH, seconds=time.perf_counter() - t0,
         dense_params=w_params,
         params_gb=sum(p_.numel() * p_.element_size() for p_ in wstate.dense.values()) / 1e9,
         moments_gb=2 * 4 * w_params / 1e9, table_gb=wstate.table.rows.numel() * 4 / 1e9,
         frames_window_shape=list(frames_shape),
         frames_window_gb=int(np.prod(frames_shape)) * 4 / 1e9,
         dims={"L": wdims.l_local, "U": wdims.u_max, "C": wdims.cap, "K": wdims.buffer_cap,
               "N": wdims.n_micro},
         start_memory_allocated_gb=start_gb,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    if wstate.dense["encoder.attn.wq"].shape != (6, 512, 512) \
            or wstate.dense["decoder.xattn.wk"].shape != (6, 512, 512) \
            or frames_shape != (N_MICRO, WHISPER_TRAIN_BATCH // N_MICRO, 1500, 512) \
            or wstate.table.rows.shape[1] != 512 or wstate.table.rows.device.type != "cuda":
        raise SystemExit(f"{WHISPER_ARCH} training is not at full width on the card")
    del wstate
    wfirst_loss = wtsess.train(1).stats.losses[0]
    torch.cuda.synchronize()

    # two steps with the first forward (with its lse) and backward call of
    # each kind kept (every call counted) and the embedding kernels' calls
    wseen = {"fwd": 0, "bwd": 0}
    wtkept = {}

    def w_lse_spy(q, k, v, causal=True):
        wseen["fwd"] += 1
        key = ("fwd", encdec_call_kind(q, k, causal))
        if key not in wtkept:
            wtkept[key] = (q.clone(), k.clone(), v.clone(), causal)
        return real_lse(q, k, v, causal)

    def w_bwd_spy(q, k, v, o, do, lse, causal=True):
        wseen["bwd"] += 1
        key = ("bwd", encdec_call_kind(q, k, causal))
        if key not in wtkept:
            wtkept[key] = (*(x.clone() for x in (q, k, v, o, do, lse)), causal)
        return real_fbwd(q, k, v, o, do, lse, causal)

    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)  # evicts the L2 (time_ms)
    fa.flash_attention_lse, fa.flash_attention_bwd = w_lse_spy, w_bwd_spy
    try:
        wcaptured = capture_calls(wtsess)
    finally:
        fa.flash_attention_lse, fa.flash_attention_bwd = real_lse, real_fbwd
    if wseen != {"fwd": 2 * WHISPER_FWD_CALLS_PER_STEP, "bwd": 2 * WHISPER_BWD_CALLS_PER_STEP} \
            or len(wtkept) != 6:
        raise SystemExit(f"two whisper steps made {wseen} attention calls of kinds "
                         f"{sorted(wtkept)}")
    wshapes = check_and_time("whisper_train", wcaptured, wtsess.state.table)
    del wcaptured
    gc.collect()
    torch.cuda.empty_cache()

    # the counted steps, each window's stream time (on the prefetch thread)
    # and its frame draw timed apart
    stream_ms, frame_ms = [], []
    real_resolve, real_draw = session_mod.resolve_stream, streams_mod.draw_frames

    def timed_resolve(*a, **kw):
        inner = real_resolve(*a, **kw)

        def windows():
            while True:
                t0_ = time.perf_counter()
                window = next(inner)
                stream_ms.append((time.perf_counter() - t0_) * 1e3)
                yield window
        return windows()

    def timed_draw(*a, **kw):
        t0_ = time.perf_counter()
        out = real_draw(*a, **kw)
        frame_ms.append((time.perf_counter() - t0_) * 1e3)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    session_mod.resolve_stream, streams_mod.draw_frames = timed_resolve, timed_draw
    try:
        t0 = time.perf_counter()
        wtrep = wtsess.train(WHISPER_TRAIN_STEPS)
        torch.cuda.synchronize()
        wwall = time.perf_counter() - t0
    finally:
        session_mod.resolve_stream, streams_mod.draw_frames = real_resolve, real_draw
    whisper_train_launches = counts()
    whisper_train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the windows drawn so far (a closed run's prefetch thread may still be
    # drawing one more)
    stream_ms, frame_ms = list(stream_ms), list(frame_ms)
    s = wtrep.summary
    wsamples_per_s = WHISPER_TRAIN_BATCH * WHISPER_TRAIN_STEPS / wwall
    windows_ = min(len(stream_ms), len(frame_ms))
    emit("whisper_train", arch=WHISPER_ARCH, mode="nestpipe", global_batch=WHISPER_TRAIN_BATCH,
         seq_len=WHISPER_TRAIN_SEQ, frames=wenc.n_frames, n_micro=N_MICRO,
         steps=WHISPER_TRAIN_STEPS, lr=LM_TRAIN_LR, bucket_slack=SLACK,
         reduced="none: every width, 6 + 6 layers, Whisper's batch of 256 segments",
         first_loss=wfirst_loss, losses=wtrep.stats.losses, overflow_max=s["overflow_max"],
         samples_per_s=wsamples_per_s,
         decoder_tokens_per_s=wsamples_per_s * WHISPER_TRAIN_SEQ,
         frames_per_s=wsamples_per_s * wenc.n_frames,
         wall_s=wwall, step_ms=[x * 1e3 for x in wtrep.stats.step_times],
         step_p50_ms=s["p50_step_s"] * 1e3, step_p99_ms=s["p99_step_s"] * 1e3,
         mean_input_wait_ms=s["mean_input_wait_s"] * 1e3,
         input_wait_ms=[x * 1e3 for x in wtrep.stats.input_wait_times],
         stage_host_ms={k: s[k] for k in ("plan_ms", "retrieve_ms", "commit_ms")},
         stream_window_ms=stream_ms, frame_draw_ms=frame_ms,
         stream_rest_ms=[a - b for a, b in zip(stream_ms[:windows_], frame_ms[:windows_])],
         stream_note="the stream's host ms a window on the prefetch thread (its frame draw "
                     "and the rest: tokens, labels), every window drawn during the run",
         launches=whisper_train_launches, max_memory_allocated_gb=whisper_train_peak_gb,
         device_memory_gb=torch.cuda.get_device_properties(0).total_memory / 1e9)
    if not all(np.isfinite(wtrep.stats.losses)) \
            or len(wtrep.stats.losses) != WHISPER_TRAIN_STEPS:
        raise SystemExit(f"whisper losses are not {WHISPER_TRAIN_STEPS} finite values")
    if not all(x < wfirst_loss for x in wtrep.stats.losses):
        raise SystemExit(f"the whisper loss did not fall from {wfirst_loss}: "
                         f"{wtrep.stats.losses}")
    if s["overflow_max"] != 0:
        raise SystemExit(f"whisper routing overflowed: {s['overflow_max']}")
    if whisper_train_peak_gb >= 80:
        raise SystemExit(f"whisper training peaked at {whisper_train_peak_gb} GB")
    whisper_train_want = {k: 0 for k in KERNELS}
    whisper_train_want.update(
        embedding_gather=(1 + 3 * N_MICRO) * WHISPER_TRAIN_STEPS,
        segment_rowsum=(N_MICRO + 1) * WHISPER_TRAIN_STEPS,
        buffer_sync=WHISPER_TRAIN_STEPS - 1, embedding_scatter=WHISPER_TRAIN_STEPS,
        flash_attention_wgmma=WHISPER_FWD_CALLS_PER_STEP * WHISPER_TRAIN_STEPS,
        flash_attention_bwd_wgmma=WHISPER_BWD_CALLS_PER_STEP * WHISPER_TRAIN_STEPS)
    if whisper_train_launches != whisper_train_want:
        raise SystemExit(f"whisper training launches {whisper_train_launches} != "
                         f"{whisper_train_want}")
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            wtsess.train(2)
            torch.cuda.synchronize()
            span = time.perf_counter() - t0
        emit_profile(prof, "whisper_train_profile", span, steps=2)
        del prof
    del wtsess, wtwl, wtrep
    gc.collect()
    torch.cuda.empty_cache()

    def encdec_attention_rows(path, kept, flush):
        """The captured training calls of each kind (the first forward with
        its lse and the first backward: encoder, decoder, cross), on the
        card alone now: the forward and its lse checked at full shape
        against the plain versions, the backward within the bf16 bound (and
        the general backward kernel within the f32 one), each the same bits
        twice; the wgmma forward (with its lse) and backward timed beside the
        plain versions, SDPA (forward, and ``torch.autograd.grad`` through
        it; the yardstick, never called by the port) and their bf16 bounds."""
        rows = {}
        sdpa = torch.nn.functional.scaled_dot_product_attention
        for kind in ("encoder", "decoder", "cross"):
            q, k, v, causal = kept[("fwd", kind)]
            if fa.lse_variant(q, k, v) != "wgmma":
                raise SystemExit(f"{path}: the {kind} forward is not the wgmma kernel's")
            check_flash(f"{path} {kind} forward", q, k, v, causal, chunk=8)
            check_lse(f"{path} {kind} forward", q, k, v, causal)
            ops, nbytes = flash_work(q, k, causal)
            nbytes += 4 * q.shape[0] * q.shape[1] * q.shape[2]  # the lse
            by_ops, by_bytes = ops / bf16_flops(name) * 1e3, nbytes / peak * 1e3
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            row = {"kernel": "flash_attention_wgmma", "call": f"{kind} layer 0 forward "
                   "(with its lse)", "shape": list(q.shape), "kv_shape": list(k.shape),
                   "kv_heads": k.shape[2], "causal": causal,
                   "dtype": str(q.dtype).removeprefix("torch."), "operations": ops,
                   "bytes": nbytes,
                   "ms": time_ms(torch, lambda: fa.flash_attention_lse(q, k, v, causal), flush),
                   "plain_ms": time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, causal),
                                       flush),
                   "library_ms": time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=causal),
                                         flush),
                   "library_call": "scaled_dot_product_attention on (B, H, T, hd) views",
                   "bound_ms": max(by_ops, by_bytes),
                   "bound_by": "operations" if by_ops >= by_bytes else "bytes"}
            row["achieved_tflops"] = ops / row["ms"] / 1e9
            rows[("fwd", kind)] = row
            emit("kernel_shape", path=path, **row)
            del qt, kt, vt

            q, k, v, o, do, lse, causal = kept[("bwd", kind)]
            if fa.bwd_variant(q, k, v) != "wgmma":
                raise SystemExit(f"{path}: the {kind} backward is not the wgmma kernel's")
            errs = check_flash_bwd(f"{path} {kind} backward", q, k, v, causal, chunk=8,
                                   given=(o, do, lse))
            ops, nbytes = flash_bwd_work(q, k, causal)
            by_ops, by_bytes = ops / bf16_flops(name) * 1e3, nbytes / peak * 1e3
            leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
            lib_out = sdpa(*leaves, is_causal=causal)
            do_t = do.transpose(1, 2)
            row = {"kernel": "flash_attention_bwd_wgmma", "call": f"{kind} layer 5 backward",
                   "shape": list(q.shape), "kv_shape": list(k.shape), "kv_heads": k.shape[2],
                   "causal": causal, "dtype": str(q.dtype).removeprefix("torch."),
                   "operations": ops, "bytes": nbytes,
                   "ms": time_ms(torch, lambda: fa.flash_attention_bwd(q, k, v, o, do, lse,
                                                                       causal), flush),
                   "plain_ms": time_ms(torch, lambda: ref.flash_attention_bwd_ref(
                       q, k, v, o, do, lse, causal), flush),
                   "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                       lib_out, leaves, do_t, retain_graph=True), flush),
                   "library_call": "torch.autograd.grad through scaled_dot_product_attention "
                                   "on (B, H, T, hd) views (its backward alone)",
                   "max_abs_err": max(errs["wgmma"].values()),
                   "bound_ms": max(by_ops, by_bytes),
                   "bound_by": "operations" if by_ops >= by_bytes else "bytes"}
            row["achieved_tflops"] = ops / row["ms"] / 1e9
            rows[("bwd", kind)] = row
            emit("kernel_shape", path=path, **row)
            del leaves, lib_out, do_t
        return rows

    wattn = encdec_attention_rows("whisper_train", wtkept, flush)
    del wtkept, flush
    gc.collect()
    torch.cuda.empty_cache()
    emit("whisper_train_phase", seconds=time.perf_counter() - t_phase)

    # -- 13m. encoder-decoder consistency -----------------------------------------
    # whisper-base-reduced nestpipe = serial = the reference, async diverging;
    # whisper-base at every width, bf16, 2 + 2 layers and all 1,500 frames (2
    # segments of 32 tokens, N = 2) on the card and on the CPU from one state
    t_phase = time.perf_counter()
    whisper_runs = {"adam_eps_1e-6": reduced_gaps(adam_eps=1e-6, arch=WHISPER_ARCH),
                    "default_step_sizes": reduced_gaps(arch=WHISPER_ARCH)}
    wfull = get_arch(WHISPER_ARCH).config
    w2cfg = dataclasses.replace(wfull, name="whisper-base-2-layers", n_layers=2,
                                encoder=dataclasses.replace(wfull.encoder, n_layers=2))
    w2arch = ArchSpec(w2cfg.name, "encdec", w2cfg, w2cfg)
    w2kw = dict(npcfg=NestPipeConfig(fwp_microbatches=2), global_batch=2, seq_len=32,
                t_chunk=64)
    w2gpu = Session.from_workload(assemble_workload(w2arch, w2cfg, device=dev, **w2kw), seed=3)
    w2cpu = Session.from_workload(assemble_workload(w2arch, w2cfg, device="cpu", **w2kw),
                                  seed=3)
    w2cpu.state = clone_state(w2gpu.state, "cpu")
    reset_counts()
    w2got = w2gpu.train(3)
    w2_launches = {k: v for k, v in counts().items() if v}
    t0 = time.perf_counter()
    w2want = w2cpu.train(3)
    w2cpu_s = time.perf_counter() - t0
    w2_gap = [abs(a - b) / abs(b) for a, b in zip(w2got.stats.losses, w2want.stats.losses)]
    emit("whisper_consistency", arch=f"{WHISPER_ARCH} (reduced)", steps=CONSISTENCY_STEPS,
         **whisper_runs, two_layers_full_width={
             "config": "2 + 2 layers at every width, 1,500 frames, f32 params, bf16 compute, "
                       "2 x 32 tokens, N = 2",
             "losses_card": w2got.stats.losses, "losses_cpu": w2want.stats.losses,
             "relative_gap": w2_gap, "bound": LM_BF16_LOSS_RTOL, "launches": w2_launches,
             "cpu_seconds": w2cpu_s},
         seconds=time.perf_counter() - t_phase,
         bounds="rows, dense and accum within 1e-5 at AdamW eps 1e-6 and at the default "
                "eps; async more than 1e-6 from the reference; the 2 + 2-layer losses within "
                f"{LM_BF16_LOSS_RTOL} of the CPU's")
    for label, run in whisper_runs.items():
        if not run["reference_same_bits_twice"]:
            raise SystemExit(f"the whisper reference gave other bits on a second run ({label})")
        wgaps = run["max_diff_to_reference"]
        for key in ("nestpipe", "serial", "nestpipe_vs_serial"):
            if wgaps[key]["rows_dense"] > 1e-5 or wgaps[key]["accum_abs"] > 1e-5:
                raise SystemExit(f"whisper {key} differs from the reference ({label}): {wgaps}")
        if wgaps["async"]["rows_dense"] <= 1e-6:
            raise SystemExit(f"whisper async did not diverge ({label}): {wgaps}")
    # 6 attention calls a micro-batch (2 encoder, 2 decoder, 2 cross) x 2
    # micro-batches x 3 steps, each forward twice (remat)
    if w2_launches.get("flash_attention_wgmma", 0) != 6 * 2 * 2 * 3 \
            or w2_launches.get("flash_attention_bwd_wgmma", 0) != 6 * 2 * 3 \
            or any(w2_launches.get(k, 0) for k in (
                "flash_attention_simple", "flash_attention_tf32x3",
                "flash_attention_bwd_simple", "flash_attention_bwd_tf32x3")):
        raise SystemExit(f"the 2 + 2-layer whisper launched {w2_launches}")
    if not all(np.isfinite(w2got.stats.losses)) or max(w2_gap) > LM_BF16_LOSS_RTOL:
        raise SystemExit(f"the 2 + 2-layer whisper losses on the card are {w2_gap} from the "
                         "CPU's")
    del w2gpu, w2cpu, w2got, w2want
    gc.collect()
    torch.cuda.empty_cache()
    emit("whisper_consistency_phase", seconds=time.perf_counter() - t_phase)

    # -- 13n. main path: full-width pixtral-12b serving -----------------------
    # every width and all 40 layers (32 heads of 160 over 8, bf16) through
    # Session.from_arch at 13's shape, the prompts behind 256 stub patches
    # (2,304 positions a prefill, a cache of 2,336): 40 wgmma forwards and 96
    # gathers a serve, the same tokens twice, the prefill against the plain
    # attention, a prefill and a decode step against the longer prefill, the
    # first and the last layer's calls checked and timed
    t_phase = time.perf_counter()
    start_gb = torch.cuda.memory_allocated() / 1e9
    psess = Session.from_arch(PIXTRAL_ARCH, seed=0)
    pwl, pcfg = psess.workload, psess.workload.cfg
    pa_ = pcfg.attention
    n_patches = pcfg.frontend.n_positions
    if (pcfg.n_layers, pcfg.d_model, pcfg.d_ff, pcfg.vocab_size, pa_.n_heads, pa_.n_kv_heads,
            pa_.head_dim, pcfg.frontend.kind, n_patches, pcfg.compute_dtype) != (
                40, 5120, 14336, 131072, 32, 8, 160, "vision", 256, "bfloat16") \
            or pwl.arch.kind != "lm":
        raise SystemExit(f"{PIXTRAL_ARCH} is not at its published widths")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pparams, ptable = psess.lm_weights()
    torch.cuda.synchronize()
    pdraw_s = time.perf_counter() - t0
    pweights_gb = sum(p_.numel() * p_.element_size() for p_ in pparams.values()) / 1e9
    kept_pflash, pflash_calls = {}, [0]

    def pflash_spy(q, k, v, causal=True):
        i = pflash_calls[0]
        pflash_calls[0] += 1
        if i in (0, pcfg.n_layers - 1):
            kept_pflash[i] = (q.clone(), k.clone(), v.clone(), causal)
        return real_flash(q, k, v, causal)

    dispatch.flash_attention = pflash_spy
    try:
        t0 = time.perf_counter()
        pwarm, pkept_gather, pn_gathers = serve_keeping_gathers(
            ptable, lambda: psess.serve(batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN))
        torch.cuda.synchronize()
        pwarm_s = time.perf_counter() - t0
    finally:
        dispatch.flash_attention = real_flash
    if pflash_calls[0] != pcfg.n_layers or kept_pflash[0][0].shape[1] != n_patches + LM_PROMPT:
        raise SystemExit(f"the warm-up pixtral serve made {pflash_calls[0]} flash calls")
    # its gathers at their shapes (the master's 5,120-wide f32 rows, then
    # bf16 rows); the patches are no lookup
    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)  # evicts the L2 (time_ms)
    vlm_gathers = check_serve_gathers("vlm_serve", pkept_gather, pn_gathers, 1 + decode_steps,
                                      ptable)
    del pkept_gather
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    prep = psess.serve(batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN)
    torch.cuda.synchronize()
    vlm_serve_launches = counts()
    vlm_serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ps_ = prep.summary
    cache_positions = n_patches + LM_PROMPT + LM_GEN
    emit("vlm_serve", arch=PIXTRAL_ARCH, batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN,
         patches=n_patches, prefill_positions=n_patches + LM_PROMPT,
         cache_positions=cache_positions,
         reduced="none: every width and 40 layers; batch 8, prompt 2048 behind 256 patches, "
                 "32 generated (decode_32k: batch 128 x 32,768)",
         config={k: getattr(pcfg, k) for k in ("n_layers", "d_model", "d_ff", "vocab_size",
                                               "param_dtype", "compute_dtype")},
         heads=[pa_.n_heads, pa_.n_kv_heads, pa_.head_dim], params=pcfg.param_count(),
         weights_gb=pweights_gb, table_gb=ptable.rows.numel() * 4 / 1e9,
         kv_cache_gb=2 * pcfg.n_layers * LM_BATCH * cache_positions * pa_.n_kv_heads
         * pa_.head_dim * 2 / 1e9,
         prefill_s=ps_["prefill_s"],
         prompt_tokens_per_s=LM_BATCH * LM_PROMPT / ps_["prefill_s"],
         prefill_positions_per_s=LM_BATCH * (n_patches + LM_PROMPT) / ps_["prefill_s"],
         decode_s=ps_["decode_s"], decode_step_ms=ps_["decode_s"] / decode_steps * 1e3,
         generated_tokens_per_s=ps_["tokens_per_s"], weights_draw_s=pdraw_s,
         warmup_serve_s=pwarm_s, launches=vlm_serve_launches,
         max_memory_allocated_gb=vlm_serve_peak_gb, start_memory_allocated_gb=start_gb,
         sample_tokens=ps_["sample_tokens"])
    vlm_serve_want = {k: 0 for k in KERNELS}
    vlm_serve_want.update(embedding_gather=3 * (1 + decode_steps),
                          flash_attention_wgmma=pcfg.n_layers)
    if vlm_serve_launches != vlm_serve_want:
        raise SystemExit(f"pixtral serving launches {vlm_serve_launches} != {vlm_serve_want}")
    if not np.array_equal(prep.tokens, pwarm.tokens):
        raise SystemExit("two pixtral serves of the same weights generated different tokens")
    if prep.tokens.shape != (LM_BATCH, LM_GEN) or not (
            (0 <= prep.tokens) & (prep.tokens < pcfg.vocab_size)).all():
        raise SystemExit(f"pixtral tokens {prep.tokens.shape} are not vocabulary ids")

    # the prefill with the kernel and with the plain attention, on the
    # serve's prompts and patches (Session.serve's draw: the prompts, then
    # the patches, from one rng)
    prng = np.random.default_rng(psess.seed)
    toks = prng.integers(0, pcfg.vocab_size, size=(LM_BATCH, LM_PROMPT))
    ppatches = torch.as_tensor(prng.normal(size=(LM_BATCH, n_patches, pcfg.d_model))
                               .astype(np.float32) * 0.02, device=dev)
    with torch.inference_mode():
        pkeys = pwl.spec.scramble(torch.as_tensor(toks.astype(np.int32), device=dev))
        emb, _ = pwl.engine.lookup_from_master(ptable, pkeys)
        emb = torch.cat([ppatches.to(emb.dtype), emb], dim=1)
        logits_k, cache = pwl.bundle.prefill(pparams, emb, cache_len=cache_positions)
        del cache
        dispatch.flash_attention = ref.flash_attention_ref
        try:
            logits_p, cache = pwl.bundle.prefill(pparams, emb, cache_len=cache_positions)
        finally:
            dispatch.flash_attention = real_flash
        del cache
    scale = float(logits_p.abs().max())
    logit_gap = float((logits_k - logits_p).abs().max())
    first_tok = logits_k.argmax(-1).cpu().numpy()
    emit("vlm_prefill_vs_plain", max_abs_logit=scale, max_logit_gap=logit_gap,
         gap_share=logit_gap / scale, bound_share=LM_LOGIT_RTOL,
         greedy_tokens_agreeing=float((logits_k.argmax(-1) == logits_p.argmax(-1))
                                      .float().mean()),
         first_token_equals_serve=bool(np.array_equal(first_tok, prep.tokens[:, 0])))
    if not np.isfinite(logits_k.cpu().numpy()).all() or logit_gap > LM_LOGIT_RTOL * scale:
        raise SystemExit(f"pixtral prefill logits with the kernel are {logit_gap} from the "
                         f"plain attention's (max |logit| {scale})")
    if not np.array_equal(first_tok, prep.tokens[:, 0]):
        raise SystemExit("the pixtral prefill's argmax is not the serve's first token")
    del logits_k, logits_p
    prefill_plus_decode(psess, pparams, ptable, "vlm", prefix=ppatches)

    if args.profile:  # the prefill, then 8 decode steps from its cache
        from torch.profiler import ProfilerActivity, profile

        with torch.inference_mode():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                logits, cache = pwl.bundle.prefill(pparams, emb, cache_len=cache_positions)
                tok = logits.argmax(-1).to(torch.int32)
                torch.cuda.synchronize()
                span = time.perf_counter() - t0
            emit_profile(prof, "vlm_prefill_profile", span, prefills=1)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(8):
                    demb, _ = pwl.engine.lookup_from_master(ptable,
                                                            pwl.spec.scramble(tok[:, None]))
                    logits, cache = pwl.bundle.decode_step(pparams, demb, cache)
                    tok = logits.argmax(-1).to(torch.int32)
                    tok.cpu()  # as serve() reads each token back
                torch.cuda.synchronize()
                span = time.perf_counter() - t0
            emit_profile(prof, "vlm_decode_profile", span, steps=8)
            del prof, logits, cache, demb
    del psess, pwl, pparams, ptable, pwarm, prep, ppatches, pkeys, emb
    gc.collect()
    torch.cuda.empty_cache()
    pfrows = prefill_flash_rows("vlm_serve", kept_pflash, flush)
    del kept_pflash, flush
    gc.collect()
    torch.cuda.empty_cache()
    emit("vlm_serve_phase", seconds=time.perf_counter() - t_phase)

    # -- 13o. main path: pixtral-12b training at full width, 6 of 40 layers --
    # at stablelm-3b's training cell (batch 8 x 4,096 positions: 256 zero
    # patches from the stream, then 3,840 text keys; N = 4, lr 3e-5): the
    # wgmma forward with its lse and the wgmma backward at hd 160, the
    # data-path kernels; then the consistency of pixtral-12b-reduced and a
    # narrow bf16 VLM at hd 160 on the card against the CPU. The two capture
    # steps keep copies of a step's buffers on top of the 69 GB training
    # peak; with the default segments a run has found 5.6 GiB reserved but
    # split too finely for a 1.25 GiB gradient there. Expandable segments
    # map freed pages back into one range: on for this phase alone (the
    # whole script under them ran 10-30% slower a phase)
    t_phase = time.perf_counter()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    start_gb = torch.cuda.memory_allocated() / 1e9
    ptcfg = dataclasses.replace(get_arch(PIXTRAL_ARCH).config, n_layers=PIXTRAL_TRAIN_LAYERS)
    ptwl = assemble_workload(
        ArchSpec(PIXTRAL_ARCH, "lm", ptcfg, ptcfg), ptcfg, device=dev, mode="nestpipe",
        npcfg=NestPipeConfig(fwp_microbatches=N_MICRO, bucket_slack=4.0),
        global_batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ, t_chunk=64)
    pts = Session.from_workload(ptwl, opt_cfg=OptimizerConfig(lr=LM_TRAIN_LR), seed=0,
                                data_seed=0)
    ptdims = ptwl.engine.dims(ptwl.batch_shapes["keys"][0][1:], N_MICRO)
    patch_shape = ptwl.batch_shapes["patches"][0]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ptstate = pts.state
    torch.cuda.synchronize()
    pt_params = sum(p_.numel() for p_ in ptstate.dense.values())
    emit("vlm_train_init", arch=PIXTRAL_ARCH, layers=PIXTRAL_TRAIN_LAYERS,
         seconds=time.perf_counter() - t0,
         config={k: getattr(ptcfg, k) for k in ("n_layers", "d_model", "d_ff", "vocab_size",
                                                "param_dtype", "compute_dtype")},
         heads=[ptcfg.attention.n_heads, ptcfg.attention.n_kv_heads,
                ptcfg.attention.head_dim],
         dense_params=pt_params,
         params_gb=sum(p_.numel() * p_.element_size() for p_ in ptstate.dense.values()) / 1e9,
         moments_gb=2 * 4 * pt_params / 1e9, table_gb=ptstate.table.rows.numel() * 4 / 1e9,
         keys_window_shape=list(ptwl.batch_shapes["keys"][0]),
         patches_window_shape=list(patch_shape),
         patches_window_gb=int(np.prod(patch_shape)) * 4 / 1e9,
         dims={"L": ptdims.l_local, "U": ptdims.u_max, "C": ptdims.cap,
               "K": ptdims.buffer_cap, "N": ptdims.n_micro},
         start_memory_allocated_gb=start_gb,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    if ptstate.dense["blocks.0.attn.wq"].shape != (PIXTRAL_TRAIN_LAYERS, 5120, 5120) \
            or ptstate.dense["blocks.0.mlp.wi"].shape != (PIXTRAL_TRAIN_LAYERS, 5120, 14336) \
            or patch_shape != (N_MICRO, LM_TRAIN_BATCH // N_MICRO, 256, 5120) \
            or ptwl.batch_shapes["keys"][0][2] != LM_TRAIN_SEQ - 256 \
            or ptstate.table.rows.shape[1] != 5120 or ptstate.table.rows.device.type != "cuda":
        raise SystemExit(f"{PIXTRAL_ARCH} training is not at full width on the card")
    del ptstate
    pfirst_loss = pts.train(1).stats.losses[0]
    torch.cuda.synchronize()

    # two steps with the first forward (with its lse) and backward kept,
    # every call counted, and the embedding kernels' calls captured
    pseen, ptkept = {"fwd": 0, "bwd": 0}, {}
    torch.cuda.reset_peak_memory_stats()

    def vlm_lse_spy(q, k, v, causal=True):
        pseen["fwd"] += 1
        if "fwd" not in ptkept:
            ptkept["fwd"] = (q.clone(), k.clone(), v.clone(), causal)
        return real_lse(q, k, v, causal)

    def vlm_bwd_spy(q, k, v, o, do, lse, causal=True):
        pseen["bwd"] += 1
        if "bwd" not in ptkept:
            ptkept["bwd"] = (*(x.clone() for x in (q, k, v, o, do, lse)), causal)
        return real_fbwd(q, k, v, o, do, lse, causal)

    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)  # evicts the L2 (time_ms)
    fa.flash_attention_lse, fa.flash_attention_bwd = vlm_lse_spy, vlm_bwd_spy
    try:
        pcaptured = capture_calls(pts)
    finally:
        fa.flash_attention_lse, fa.flash_attention_bwd = real_lse, real_fbwd
    if pseen != {"fwd": 2 * PIXTRAL_FWD_CALLS_PER_STEP, "bwd": 2 * PIXTRAL_BWD_CALLS_PER_STEP}:
        raise SystemExit(f"two pixtral steps made {pseen} attention calls")
    capture_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ptshapes = check_and_time("vlm_train", pcaptured, pts.state.table)
    del pcaptured
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    ptrep = pts.train(PIXTRAL_TRAIN_STEPS)
    torch.cuda.synchronize()
    pwall = time.perf_counter() - t0
    vlm_train_launches = counts()
    vlm_train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    s = ptrep.summary
    psamples_per_s = LM_TRAIN_BATCH * PIXTRAL_TRAIN_STEPS / pwall
    emit("vlm_train", arch=PIXTRAL_ARCH, layers=PIXTRAL_TRAIN_LAYERS, mode="nestpipe",
         global_batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ, patches=256, n_micro=N_MICRO,
         steps=PIXTRAL_TRAIN_STEPS, lr=LM_TRAIN_LR,
         reduced=f"every width, {PIXTRAL_TRAIN_LAYERS} of 40 layers; batch 8 of train_4k's "
                 "256 (one of 32 workers)",
         first_loss=pfirst_loss, losses=ptrep.stats.losses, overflow_max=s["overflow_max"],
         samples_per_s=psamples_per_s, tokens_per_s=psamples_per_s * LM_TRAIN_SEQ,
         text_tokens_per_s=psamples_per_s * (LM_TRAIN_SEQ - 256),
         wall_s=pwall, step_ms=[x * 1e3 for x in ptrep.stats.step_times],
         step_p50_ms=s["p50_step_s"] * 1e3, step_p99_ms=s["p99_step_s"] * 1e3,
         mean_input_wait_ms=s["mean_input_wait_s"] * 1e3,
         stage_host_ms={k: s[k] for k in ("plan_ms", "retrieve_ms", "commit_ms")},
         launches=vlm_train_launches, max_memory_allocated_gb=vlm_train_peak_gb,
         capture_max_memory_allocated_gb=capture_peak_gb,
         device_memory_gb=torch.cuda.get_device_properties(0).total_memory / 1e9)
    if not all(np.isfinite(ptrep.stats.losses)) \
            or len(ptrep.stats.losses) != PIXTRAL_TRAIN_STEPS:
        raise SystemExit(f"pixtral losses are not {PIXTRAL_TRAIN_STEPS} finite values")
    if not all(x < pfirst_loss for x in ptrep.stats.losses):
        raise SystemExit(f"the pixtral loss did not fall from {pfirst_loss}: "
                         f"{ptrep.stats.losses}")
    if s["overflow_max"] != 0:
        raise SystemExit(f"pixtral routing overflowed: {s['overflow_max']}")
    if vlm_train_peak_gb >= 80:
        raise SystemExit(f"pixtral training peaked at {vlm_train_peak_gb} GB")
    vlm_train_want = {k: 0 for k in KERNELS}
    vlm_train_want.update(embedding_gather=(1 + 3 * N_MICRO) * PIXTRAL_TRAIN_STEPS,
                          segment_rowsum=(N_MICRO + 1) * PIXTRAL_TRAIN_STEPS,
                          buffer_sync=PIXTRAL_TRAIN_STEPS - 1,
                          embedding_scatter=PIXTRAL_TRAIN_STEPS,
                          flash_attention_wgmma=PIXTRAL_FWD_CALLS_PER_STEP * PIXTRAL_TRAIN_STEPS,
                          flash_attention_bwd_wgmma=PIXTRAL_BWD_CALLS_PER_STEP
                          * PIXTRAL_TRAIN_STEPS)
    if vlm_train_launches != vlm_train_want:
        raise SystemExit(f"pixtral training launches {vlm_train_launches} != {vlm_train_want}")
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pts.train(2)
            torch.cuda.synchronize()
            span = time.perf_counter() - t0
        emit_profile(prof, "vlm_train_profile", span, steps=2)
        del prof
    del pts, ptwl, ptrep
    gc.collect()
    torch.cuda.empty_cache()
    vlm_attn = train_attention_rows("vlm_train", ptkept, flush, PIXTRAL_TRAIN_LAYERS - 1,
                                    wgmma_first=True)
    del ptkept, flush
    gc.collect()
    torch.cuda.empty_cache()

    # consistency: pixtral-12b-reduced nestpipe = serial = the reference,
    # async diverging; a narrow bf16 VLM at pixtral's head dim (2 layers, 2
    # heads of 160 over 1, d_model 320, 8 patches) on the card and on the
    # CPU from one state
    vlm_runs = {"adam_eps_1e-6": reduced_gaps(adam_eps=1e-6, arch=PIXTRAL_ARCH),
                "default_step_sizes": reduced_gaps(arch=PIXTRAL_ARCH)}
    red = get_arch(PIXTRAL_ARCH).reduced
    vcfg = dataclasses.replace(red, name="pixtral-12b-bf16-hd160", d_model=320, d_ff=512,
                               param_dtype="bfloat16", compute_dtype="bfloat16",
                               attention=dataclasses.replace(red.attention, n_heads=2,
                                                             n_kv_heads=1, head_dim=160))
    varch = ArchSpec(vcfg.name, "lm", vcfg, vcfg)
    vkw = dict(global_batch=8, seq_len=200, t_chunk=64)
    vgpu = Session.from_workload(assemble_workload(varch, vcfg, device=dev, **vkw), seed=3)
    vcpu = Session.from_workload(assemble_workload(varch, vcfg, device="cpu", **vkw), seed=3)
    vcpu.state = clone_state(vgpu.state, "cpu")
    reset_counts()
    vgot = vgpu.train(3)
    v_launches = {k: v for k, v in counts().items() if v}
    vwant = vcpu.train(3)
    v_gap = [abs(a - b) / abs(b) for a, b in zip(vgot.stats.losses, vwant.stats.losses)]
    emit("vlm_consistency", arch=f"{PIXTRAL_ARCH} (reduced)", steps=CONSISTENCY_STEPS,
         **vlm_runs, bf16_hd160={"config": "2 layers, 2 heads of 160 over 1, d_model 320, "
                                           "8 patches, bf16, 8 x 200 positions",
                                 "losses_card": vgot.stats.losses,
                                 "losses_cpu": vwant.stats.losses,
                                 "relative_gap": v_gap, "bound": LM_BF16_LOSS_RTOL,
                                 "launches": v_launches},
         bounds="rows, dense and accum within 1e-5 at AdamW eps 1e-6 and at the default "
                "eps; async more than 1e-6 from the reference; the bf16 config's losses "
                f"within {LM_BF16_LOSS_RTOL} of the CPU's")
    for label, run in vlm_runs.items():
        if not run["reference_same_bits_twice"]:
            raise SystemExit(f"the pixtral reference gave other bits on a second run ({label})")
        vgaps = run["max_diff_to_reference"]
        for key in ("nestpipe", "serial", "nestpipe_vs_serial"):
            if vgaps[key]["rows_dense"] > 1e-5 or vgaps[key]["accum_abs"] > 1e-5:
                raise SystemExit(f"pixtral {key} differs from the reference ({label}): {vgaps}")
        if vgaps["async"]["rows_dense"] <= 1e-6:
            raise SystemExit(f"pixtral async did not diverge ({label}): {vgaps}")
    # 2 layers x N_MICRO micro-batches x 3 steps, each forward twice (remat)
    if v_launches.get("flash_attention_wgmma", 0) != 2 * 2 * N_MICRO * 3 \
            or v_launches.get("flash_attention_bwd_wgmma", 0) != 2 * N_MICRO * 3 \
            or any(v_launches.get(k, 0) for k in (
                "flash_attention_simple", "flash_attention_tf32x3",
                "flash_attention_bwd_simple", "flash_attention_bwd_tf32x3")):
        raise SystemExit(f"the bf16 hd-160 VLM launched {v_launches}")
    if not all(np.isfinite(vgot.stats.losses)) or max(v_gap) > LM_BF16_LOSS_RTOL:
        raise SystemExit(f"the bf16 hd-160 VLM losses on the card are {v_gap} from the CPU's")
    del vgpu, vcpu, vgot, vwant
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    emit("vlm_train_phase", seconds=time.perf_counter() - t_phase)

    # -- 14. kernels line and the result -----------------------------------
    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        by_path = {"dlrm_train": train_launches[kname],
                   "dlrm_serve": serve_launches[kname],
                   "dlrm_host_train": host_train_launches[kname],
                   "dlrm_cached_train": cached_train_launches[kname],
                   "dlrm_cached_serve": cached_serve_launches[kname],
                   "dlrm_cached_pack_serve": cached_pack_serve_launches[kname],
                   **{path: path_launches[run][kname]
                      for run, path in TIER_PATHS.items()},
                   "dlrm_ckpt_resume_train": ckpt_launches[kname],
                   "dlrm_preempt_resume_train": path_launches["preempt-resume"][kname],
                   "hstu_train": hstu_launches[kname],
                   "fuxi_train": fuxi_launches[kname],
                   "lm_serve": lm_launches[kname],
                   "lm_train": lm_train_launches[kname],
                   "moe_serve": moe_serve_launches[kname],
                   "moe_train": moe_train_launches[kname],
                   "moe_ckpt_resume_train": moe_ckpt_launches[kname],
                   "mamba_serve": mamba_serve_launches[kname],
                   "mamba_train": mamba_train_launches[kname],
                   "jamba_serve": jamba_serve_launches[kname],
                   "whisper_serve": whisper_serve_launches[kname],
                   "whisper_train": whisper_train_launches[kname],
                   "vlm_serve": vlm_serve_launches[kname],
                   "vlm_train": vlm_train_launches[kname]}
        for path in RUNS_ON[kname]:
            if by_path[path] == 0:
                raise SystemExit(f"{kname} was not launched on the {path} path")
        if kname == "flash_attention_wgmma":
            row = frows[0]
            entry = {
                "name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": max(v for k, v in fworst.items() if k.startswith(kname)),
                "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "ms_of": "one call at the main-path shape " + str(row["shape"])
                         + f" over {row['kv_heads']} kv heads, bf16, causal",
                "calls_per_serve": lm_launches[kname],
                "last_layer": {k: frows[-1][k] for k in ("ms", "plain_ms", "library_ms",
                                                         "bound_ms")},
                "lse_max_abs_err": lse_worst["flash_attention_wgmma bfloat16"],
                "calls_per_lm_train_step": LM_FWD_CALLS_PER_STEP,
                "lm_train_call": {k: lm_attn[kname][k] for k in (
                    "shape", "ms", "without_lse_ms", "simple_ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by", "achieved_tflops")},
                # olmoe's hd-128 calls: its prefill's first layer, and its
                # training's first forward with the lse
                "moe_serve_call": {k: mfrows[0][k] for k in (
                    "shape", "ms", "simple_ms", "plain_ms", "library_ms", "bound_ms",
                    "achieved_tflops")},
                "calls_per_moe_serve": moe_serve_launches[kname],
                "moe_train_call": {k: moe_attn[kname][k] for k in (
                    "shape", "ms", "without_lse_ms", "simple_ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by", "achieved_tflops")},
                "calls_per_moe_train_step": MOE_FWD_CALLS_PER_STEP,
                # jamba's one attention layer in 8 (hd 128, 32 heads over 8)
                "jamba_serve_call": {k: jfrows[0][k] for k in (
                    "shape", "ms", "simple_ms", "plain_ms", "library_ms", "bound_ms",
                    "achieved_tflops")},
                "calls_per_jamba_serve": jamba_serve_launches[kname],
                # whisper's hd-64 calls: the prefill's layer 0 encoder (no mask,
                # T 1,500), decoder (causal) and cross (the prompt against the
                # frames), and training's, each with its lse
                "whisper_serve_calls": [{k: row_[k] for k in (
                    "call", "shape", "kv_shape", "causal", "ms", "simple_ms", "plain_ms",
                    "library_ms", "bound_ms", "achieved_tflops")} for row_ in wfrows],
                "calls_per_whisper_serve": whisper_serve_launches[kname],
                "whisper_train_calls": [{k: wattn[("fwd", kind)][k] for k in (
                    "call", "shape", "kv_shape", "causal", "ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by", "achieved_tflops")}
                    for kind in ("encoder", "decoder", "cross")],
                "calls_per_whisper_train_step": WHISPER_FWD_CALLS_PER_STEP,
                # pixtral's hd-160 calls: its prefill's first and last layer
                # (2,304 positions: the patches, then the prompt), and its
                # training's first forward with the lse
                "vlm_serve_calls": [{k: row_[k] for k in (
                    "call", "shape", "ms", "simple_ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by", "achieved_tflops")} for row_ in pfrows],
                "calls_per_vlm_serve": vlm_serve_launches[kname],
                "vlm_train_call": {k: vlm_attn[kname][k] for k in (
                    "shape", "ms", "without_lse_ms", "simple_ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by", "achieved_tflops")},
                "calls_per_vlm_train_step": PIXTRAL_FWD_CALLS_PER_STEP,
            }
        elif kname == "flash_attention_bwd_wgmma":  # LM training's backward
            row = lm_attn[kname]
            entry = {
                "name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": max([row["max_abs_err"]] + [
                    v for k, v in bworst.items() if k.startswith(kname)]),
                "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "ms_of": f"one call at the LM-training shape {row['shape']} over "
                         f"{row['kv_heads']} kv heads, bf16, causal ({row['call']}; the mean "
                         "of two turns, in turns with the general kernel)",
                "ms_turns": row["ms_turns"],
                "calls_per_lm_train_step": LM_BWD_CALLS_PER_STEP,
                "achieved_tflops": row["achieved_tflops"],
                "x_faster_than_simple": row["x_faster_than_simple"],
                "max_share_of_bound": max(v for k, v in bshare.items() if k.startswith(kname)),
                "moe_train_call": {k: moe_attn[kname][k] for k in (
                    "shape", "ms", "ms_turns", "plain_ms", "library_ms", "bound_ms",
                    "bound_by", "achieved_tflops", "x_faster_than_simple")},
                "calls_per_moe_train_step": MOE_BWD_CALLS_PER_STEP,
                "whisper_train_calls": [{k: wattn[("bwd", kind)][k] for k in (
                    "call", "shape", "kv_shape", "causal", "ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by", "achieved_tflops", "max_abs_err")}
                    for kind in ("encoder", "decoder", "cross")],
                "calls_per_whisper_train_step": WHISPER_BWD_CALLS_PER_STEP,
                # pixtral's hd-160 call (the dk/dv kernel 32 queries a tile)
                "vlm_train_call": {k: vlm_attn[kname][k] for k in (
                    "shape", "kv_heads", "ms", "ms_turns", "plain_ms", "library_ms", "bound_ms",
                    "bound_by", "achieved_tflops", "x_faster_than_simple", "max_abs_err")},
                "calls_per_vlm_train_step": PIXTRAL_BWD_CALLS_PER_STEP,
            }
        elif kname == "flash_attention_bwd_simple":  # on no main path; pixtral's call timed
            row, lrow, frow = vlm_attn[kname], lm_attn[kname], fuxi_attn[kname]
            entry = {
                "name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": max([fuxi_err[kname], row["max_abs_err"], lrow["max_abs_err"]]
                                   + [v for k, v in bworst.items() if k.startswith(kname)]),
                "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "ms_of": f"one call at pixtral-12b training's shape {row['shape']} over "
                         f"{row['kv_heads']} kv heads, bf16, causal ({row['call']}; the mean "
                         "of two turns, in turns with the wgmma backward)",
                "ms_turns": row["ms_turns"],
                "achieved_tflops": row["achieved_tflops"],
                # stablelm-3b's hd-80 call, in turns with the wgmma backward
                "lm_train_shape": {k: lrow[k] for k in ("shape", "ms", "ms_turns", "plain_ms",
                                                        "library_ms", "bound_ms",
                                                        "achieved_tflops")},
                "fuxi_shape": {k: frow[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                                    "bound_ms", "achieved_tflops")},
            }
        elif kname in fuxi_attn:  # FuXi's f32 attention: the forwards, the backward
            row = fuxi_attn[kname]
            entry = {
                "name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": max([fuxi_err[kname]] + [
                    v for k, v in {**fworst, **bworst}.items() if k.startswith(kname)]),
                "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "ms_of": f"one call at the main-path shape {row['shape']} over "
                         f"{row['kv_heads']} kv heads, f32, causal ({row['call']})",
                "calls_per_step": fuxi_want[kname] // FUXI_STEPS,
                "achieved_tflops": row["achieved_tflops"],
            }
            entry.update({k: row[k] for k in ("ms_turns", "f32_core_bound_ms", "tf32_mma_tflops",
                                              "tf32_peak_share") if k in row})
            if kname == "flash_attention_simple":  # the LM prefills' shapes, bf16
                for key, rows_ in (("lm_serve_shape", frows), ("vlm_serve_shape", pfrows)):
                    entry[key] = {
                        "ms": rows_[0]["simple_ms"],
                        **{k: rows_[0][k] for k in ("shape", "plain_ms", "library_ms",
                                                    "bound_ms")}}
        elif kname in hrows_out:
            row = hrows_out[kname]
            entry = {
                "name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": hworst[kname], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": None,
                "ms_of": "one call at the main-path shape " + str(row["shape"]),
                "calls_per_step": hstu_want[kname] // HSTU_STEPS,
                "f32_core_bound_ms": row["f32_core_bound_ms"],
            }
            entry.update({k: row[k] for k in ("tf32_mma_tflops", "tf32_peak_share") if k in row})
        else:
            rows = shapes[kname]
            entry = {
                "name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": worst[kname],
                "ms": sum(x["ms"] for x in rows),
                "plain_ms": sum(x["plain_ms"] for x in rows),
                "bound_ms": sum(x["bound_ms"] for x in rows),
                "bound_by": "bytes",
                "library_ms": (None if any(x["library_ms"] is None for x in rows)
                               else sum(x["library_ms"] for x in rows)),
                "ms_of": "one dlrm-ctr training step: " + ", ".join(x["call"] for x in rows),
                **{f"{path}_step": {
                    **{k: (None if any(x[k] is None for x in calls[kname])
                           else sum(x[k] for x in calls[kname]))
                       for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
                    "calls": [x["call"] for x in calls[kname]]}
                   for path, calls in (("hstu_train", hshapes), ("fuxi_train", fshapes),
                                       ("lm_train", tshapes), ("moe_train", mtshapes),
                                       ("mamba_train", sshapes), ("whisper_train", wshapes),
                                       ("vlm_train", ptshapes))},
            }
        if kname == "embedding_gather":
            times = ("ms", "plain_ms", "library_ms", "bound_ms")
            entry["serve_window"] = {k: sum(x[k] for x in serve_shapes) for k in times}
            # one serve of each LM path, at its own shapes
            for path, rows_ in (("lm_serve", lm_gathers), ("mamba_serve", mamba_gathers),
                                ("jamba_serve", jamba_gathers),
                                ("whisper_serve", whisper_gathers),
                                ("vlm_serve", vlm_gathers)):
                entry[path] = serve_gather_times(rows_, decode_steps)
        if kname in cached_shapes:  # the cached tier's calls (phase 6b)
            calls = cached_shapes[kname]
            entry["dlrm_cached_train_calls"] = {
                **{k: sum(x[k] for x in calls)
                   for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
                "calls": [x["call"] for x in calls]}
        if kname == "segment_rowsum":  # the op's parts per step: sort, starts, sum, combine
            for step, calls in ((entry, rows), (entry["hstu_train_step"], hshapes[kname]),
                                (entry["fuxi_train_step"], fshapes[kname]),
                                (entry["lm_train_step"], tshapes[kname]),
                                (entry["moe_train_step"], mtshapes[kname]),
                                (entry["mamba_train_step"], sshapes[kname]),
                                (entry["whisper_train_step"], wshapes[kname]),
                                (entry["vlm_train_step"], ptshapes[kname])):
                step["parts_ms"] = {k: sum(x["parts_ms"][k] for x in calls)
                                    for k in calls[0]["parts_ms"]}
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


def emit_profile(prof, phase, span, window=None, **fields):
    """Device busy time and idle share of a profiled span, and its top
    kernels and host ops. Busy time is the union of the intervals of the
    profiler's device-side events (kernels, copies, sets); an operator that
    launched a kernel carries the kernel's time too and is not counted
    again. ``window`` names a host-side ``record_function`` range: the span
    is then that range, and only device time inside it counts."""
    from torch.autograd import DeviceType

    lo, hi = float("-inf"), float("inf")
    marks = [e for e in prof.events()
             if window and e.name == window and e.device_type == DeviceType.CPU]
    if marks:
        lo, hi = marks[0].time_range.start, marks[0].time_range.end
        span = (hi - lo) / 1e6
    # device work: every device-side event but the range's own annotation
    on_device = [e for e in prof.events()
                 if e.device_type != DeviceType.CPU and not (window and e.name == window)]
    busy_us, end = 0.0, float("-inf")
    per_kernel = {}
    for e in on_device:
        a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if b > a:
            n, us = per_kernel.get(e.name, (0, 0.0))
            per_kernel[e.name] = (n + 1, us + b - a)
    for a, b in sorted((max(e.time_range.start, lo), min(e.time_range.end, hi))
                       for e in on_device):
        if b > end and b > a:
            busy_us += b - max(a, end)
            end = b
    events = prof.key_averages()
    device = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    emit(phase, **fields, wall_ms=span * 1e3, device_busy_ms=busy_us / 1e3,
         device_idle_share=1 - busy_us / 1e3 / (span * 1e3),
         device_kernels_ms=sum(us for _, us in per_kernel.values()) / 1e3,
         host_torch_ops_ms=sum(e.self_cpu_time_total for e in host) / 1e3,
         top_device=[{"name": k[:70], "count": n, "ms": us / 1e3}
                     for k, (n, us) in device[:16]],
         top_host=[{"name": e.key[:70], "count": e.count,
                    "ms": e.self_cpu_time_total / 1e3} for e in host[:10]])


if __name__ == "__main__":
    sys.exit(main())
