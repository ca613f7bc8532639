#!/usr/bin/env python3
"""Smoke test of heat_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

1. Prints the card (nvidia-smi's name and power limit) and builds the CUDA
   kernels from ``heat_tpu_torch/ops/csrc``; prints ptxas's registers and
   spills of each instance of the bfloat16 tensor-core kernels, the forward
   (``flash_fwd_tc.cuh``), dq and dk/dv (``flash_bwd_tc.cuh``), of the
   float32 forward, dq and dk/dv (``flash_f32.cuh``) and of the KMeans
   kernels (``kmeans.cu``).
2. Holds each KMeans kernel against its plain PyTorch version at k=64,
   d=32 on a ragged n=1,000,003, in float32 and bfloat16; then both at
   their edges (``EM_EDGE_CHECKS``: k of 1 to 300, products by wgmma and by
   mma.sync, d of 1 to 128, n of 0, 1, under a tile and off a block,
   bfloat16, rows in random order, rows off 16-byte alignment, and one
   cluster holding 99% of 1e6 rows; and the streamed route, past the
   centres' shared-memory layout: d = 129, 200, 256 and 512, and k one
   centre past each kernel's cap at d = 32 and 128, where assign's labels
   and em_stats' counts must still agree to the bit): assign against its
   plain version (d2 within D2_RTOL, a differing label only at a near
   tie), em_stats against its plain version and against assign's labels,
   each twice to the same bits.
3. Drives the main path at the BASELINE width: ``create_clusters`` with
   1e8 x 32 rows at split=0, ``KMeans(64, init="random", max_iter=20).fit``
   and ``predict``, in float32 and in bfloat16.  Each is held to one Lloyd
   step against the torch (``'jnp'``) path's from the same init, and to an
   inertia no higher than that one step's (Lloyd never raises it).  They are
   not held to recovering the generating means: a random init puts two
   centres in one blob and none in another, a local minimum that Lloyd keeps.
   So a ``kmeans++`` fit on the same 1e8 rows, and one at n = 2**22, must
   recover every generating mean.  The launch counts are zeroed just before
   each fit and read just after it.
3b. The array core's indexing at the sizes users index, at world size 1:
   X = 1e8 x 32 float32 split 0 (config 2's rows) and A = 16384^2 float32
   at split 0 and 1 (config 0's operand).  ``X[idx]`` (1e6 random rows),
   ``X[::2]``, ``X[::-1]``, ``X[:, 3]``, ``X[m]`` (m = ``X[:, 0] > 0``),
   ``where(X > 0, X, 0)``, ``nonzero(m)``, ``X[m] = 0``, ``X[idx] = Y`` (Y
   split 0); ``A[:, 100:200]``, ``A[5]``, ``A[:, ::2]``, ``A[A < 0] = 0``
   (split 1), ``fill_diagonal(0)``; ``identity``, ``tri`` and ``vander`` at
   16384.  Each result bit for bit torch's own indexing of the same tensor,
   its split INDEX_SPLITS' (the JAX package's rule), timed (CUDA events)
   beside its bytes bound (``index_bytes``: reads at 32-byte sectors plus
   writes, at 3.35 TB/s).  ``str(X)``: its wall time and the bytes the
   profiler saw copied to the host, at most STR_EDGE_BYTES (the edges).
   Then 2 spawned ranks on this card over gloo: every key kind on ragged
   (1001, 7) split 0, (7, 1001) split 1 and (13, 6, 5) at each split,
   ``__setitem__`` with each value kind, ``where``, ``nonzero``,
   ``fill_diagonal`` and ``str``, each exactly world size 1's (values with
   the sign of zero, gshape, split); then, on the two ranks at X's size,
   ``X[idx] = Y`` (its Alltoall bytes exactly the rows that change rank
   with their int64 positions) and ``X[::-1] = column``, each bit for bit
   torch's own assignment on each rank's rows, and timed.
3c. The random streams, statistics, manipulations and the sort at world
   size 1 at users' sizes: X = ``rand(1e8, 32)`` (also ``randn`` and
   ``randint``, each one call timed, its first 1e6 values the CPU path's
   bit for bit; randn within 1e-6), ``mean``/``var``/``std``/``argmax``
   of X along 0, 1 and None, ``cov(X, rowvar=False)``,
   ``histogram(X[:, 0], 100)``; v = ``rand(1e9)``: ``sort`` with indices,
   ``argsort``, ``percentile(v, [5, 50, 95])``, ``median``, ``topk(v,
   1000)``, 1e6 ``searchsorted``; ``unique(randint(0, 1e6, 1e9))``;
   ``reshape(X, (5e7, 64))``, ``concatenate`` of X's halves, ``roll(X,
   1000, 0)``, ``pad`` of config 0's 16384^2 operand; ``einsum('ij,ik->jk',
   X, X)``, ``kron`` to 16384^2, ``det`` and ``inv`` at 4096^2.  Each
   result on the card, its split ``STATS_SPLITS``' (the JAX package's),
   bit for bit torch's own call where the port's path is that call, else
   within STATS_RTOL of float64 on the card (of the largest entry),
   timed (CUDA events) beside ``stats_bound_ms`` and torch's call; the
   peak memory.
3d. The same surface
   on 2 spawned ranks on this card over gloo
   (``stats_cases``: the ragged shapes of tests/test_torch_sort_mp.py at
   every split, draws at every split, a 1e7-element sort), each result
   world size 1's (exact; the float reductions within STATS_2R_RTOL), and
   each rank's Alltoall bytes of the sort (at most its chunk's values and
   int64 indices).
3e. The estimators at world size 1 at users' sizes.  X =
   ``create_clusters(1e8, 32, 64)`` (config 2's data) with its blob labels:
   ``KMedians`` and ``KMedoids`` from a row of each blob (EST_ITER steps;
   one more step from the fitted centres against float64 on the card: the
   medians of the fit's labels exactly, each medoid a member row as near the
   float64 median as any), ``BatchParallelKMeans`` (MAX_ITER) and
   ``BatchParallelKMedians`` (EST_ITER; labels the assign kernel's of the
   merged centres), ``GaussianNB`` on the 64 classes (theta and var within
   NB_RTOL of float64 per blob), the five scalers (statistics against
   float64, min and max bit for bit, each transform of 1e6 rows against its
   formula in float64), ``KNeighborsClassifier(5)`` on every 100th row (1e6)
   predicting 32768 rows (256 against the float64 brute force's votes).  T,
   a rank-16 signal plus 1e-3 noise at config 1's 1e6 x 256: ``PCA`` by
   each solver at 16 components and ``'full'`` at 0.9, ``IncrementalPCA(16,
   batch_size=65536)``, singular values within PCA_RTOL of the float64
   Gram's; ``Lasso`` on randn(1e6, 256) and a 16-sparse theta plus noise
   against float64 coordinate descent (LASSO_RTOL); ``DMD`` of a known
   rank-16 system's 256 snapshots (1e6 x 256), its eigenvalues within
   DMD_TOL of the known ones; ``Spectral(8, n_lanczos=300)`` and its
   ``Laplacian`` on ``create_clusters(32768, 32, 8)`` (A is 4 GiB), the
   blobs recovered up to a permutation (SPECTRAL_AGREE).  Each fit's launch
   counts zeroed just before and read just after: KMedians and KMedoids
   launch ``assign`` once a step and once for the labels and ``em_stats``
   never (the profiler's count of one fit too), the batch-parallel fits and
   Spectral launch the KMeans kernels; each timed beside its bound
   (``stats_bound_ms``) with its peak memory under EST_PEAK.
3f. On 2 spawned ranks on this card over gloo: the tiled resplit of
   RESPLIT_2R_SHAPE (1.1 GB, tiles ragged along their axis) at
   RESPLIT_2R_CASES under RESPLIT_2R_BUDGET, bit for bit the monolithic
   resplit, its traffic bytes equal, its transient memory past source and
   destination within the budget plus one tile (the monolithic one's
   printed beside it); then ``estimator_cases`` (EST_2R_N ragged rows)
   against world size 1 on this card.
3g. I/O, fft, the convolutions, sparse and vmap at users' sizes, at world
   size 1: X = 1e7 x 32 float32 (1.28 GB) saved and loaded through
   ``.npy``, zarr and the array checkpoint (HDF5 and netCDF where ``import
   h5py`` succeeds; else the line ``{"hdf5": "h5py not installed"}``), a
   1e6 x 32 CSV, and the LM of 6 with its Adam state through the pytree
   checkpoint, each bit for bit with its split, beside torch's own
   ``.cpu()`` and ``.to('cuda')``; a corrupted chunk makes the checkpoint
   load fall back to the previous version; every file lives in a
   temporary directory removed at the end.  ``fft2``, ``ifft2`` and
   ``rfft2`` of 16384^2 split 0 (torch.fft's own result, and a 2048^2
   slice within SURF_RTOL of complex128); ``convolve`` of 1e8 samples with
   1023 taps in each mode, beside ``conv1d`` and the 2nm bound, within
   SURF_CONV_RTOL of float64 (IEEE float32, not TF32); a 1e6^2 CSR of 32
   nonzeros a row times a (1e6, 64) array beside ``torch.sparse.mm`` and
   its bytes bound, 4096 rows against float64; add, mul, transpose and
   todense at 16384^2, 1% dense; ``vmap`` of a row function over 1e6 x 32
   against the function on the whole array.  Then on 2 spawned ranks on
   this card over gloo, against world size 1 (``surface_cases``): every
   format's save and load, an array checkpoint the ranks write and this
   process reads, convolutions with chunks shorter than the halo, fft
   along the split axis, the sparse product, ``ring_map``; and DASO (2
   groups) checkpointed at step 3 and resumed into a fresh optimizer, its
   next 2 steps bit for bit the uninterrupted run's.  Each part's seconds
   and the phase's total are printed.
4. ``ht.matmul`` (BASELINE config 0): two (n, n) float32
   ``ht.random.randn(..., split=0)`` on the card multiplied at world size
   1, n = 4096 (BASELINE's shape) and 16384 (the north star's: 3 GiB for a,
   b and the result), each held against a float64 product of the same
   tensors (``MATMUL_RTOL``) and bit for bit against ``torch.matmul`` of the
   local tensors, timed beside it (TFLOP/s, the share of the float32 peak,
   peak memory), and profiled: the same device kernels as ``torch.matmul``
   and no copy.  Then 2 spawned ranks on this card over gloo: all nine
   (a.split, b.split) cases at 4096^2 and the vector products, each split
   held against the JAX package's table; ``matmul_summa`` at 4096^2 and
   ragged (4099 x 4097 x 4095); ``resplit_`` 0 -> 1 -> None -> 0 exactly;
   ``+`` with mismatched splits and beside a replicated operand; ``sum``,
   ``max`` and ``cumsum`` along both axes; each gathered and held against
   the world-1 result on the card (``MATMUL_2R_RTOL``).  Rank 0 prints the
   SUMMA and gather routes' times, the communicator's traffic and each
   collective's transport: 2 processes on ONE card, not a multi-card figure.
4b. Tall-skinny QR/SVD (BASELINE config 1) at its full size: float32
   ``ht.random.randn(1e6, 256, split=0)`` at world size 1 through
   ``ht.linalg.qr`` by CholeskyQR2 ('auto') and Householder, ``mode='r'``
   and ``ht.linalg.svd``: each timed (host clock, the card synchronised:
   CholeskyQR2 reads one flag on the host), its TFLOP/s by the standard
   count (4mn^2 - 4n^3/3) and by the products the route executes
   (``qr_flops``), its peak memory and kernels under the profiler, and held
   against float64 on the card (``QR_TOL``: ||A - QR|| / ||A||, max |Q^T Q -
   I|, tril(R, -1) = 0, S against ``svdvals`` of A in float64); 'auto'
   again with the caller's matmul precision at "high" (TF32), which the
   products must not take and must restore; the Gram's and a Q product's
   GEMM alone; ``solve_triangular`` (blocked and native) and ``cg`` at
   4096^2 against float64 solves.  Then ``ht.spatial.cdist`` (direct and
   quadratic expansion), ``manhattan`` and ``rbf`` (sigma = sqrt(2d)) of x, y
   32768 x 32 split 0 (a 4 GiB result each), on 256 sampled rows against
   float64 (relative, but the expansion's), timed
   beside the bound and ``torch.cdist``.  Then the same linear algebra on 2
   spawned ranks on this card over gloo (``linalg_cases``: every split pair
   of ``cdist`` and ``cdist_ring``, ``tsqr`` and its replicated path,
   ``svd``, ``hsvd_rank``, the blocked ``solve_triangular``, ``cg``, a
   boolean mask at split 0), each held against world size 1 on this card
   (``LINALG_2R_TOL``).
4c. Data-parallel training (BASELINE configs 3 and 4).  Config 3 at world
   size 1: 60000 x 784 MNIST-shaped float32 rows made on the card from a
   seed (class-dependent bumps), split 0, ``examples/nn_mnist_demo.py``'s
   MLP through ``DataParallel`` with Adam lr 1e-3 and
   ``DataLoader(batch_size=256, shuffle=True)``, 3 epochs: the loss falls,
   train accuracy passes 0.9, and a ``make_train_step`` step is the plain
   torch step bit for bit; samples/s, the median step and the device's
   idle share.  Config 4's model at world size 1: ``resnet50()`` (1000
   classes) on one synthetic (64, 3, 224, 224) batch, ``DataParallel`` with
   SGD lr 0.05, momentum 0.9, 20 steps in torch's default precision (TF32
   convolutions): the loss on it falls; images/s, the median step, peak memory
   and one profiled step's top kernels with cuDNN's convolution share.
   Then 2 spawned ranks on this card over gloo, in IEEE float32: one
   ``DataParallel`` SGD step of the MLP on a ragged 257-row global batch and
   of ResNet-50 on 2 x 8 images (the global batch's BatchNorm), each against
   world size 1 (the loss and, for the MLP, every parameter, ``DP_2R_RTOL``;
   ResNet-50's parameters after the same step in float64,
   ``DP_2R_F64_RTOL``, since in float32 the world-1 step itself lies ~7e-2
   from float64 on BatchNorm biases whose gradients cancel); ``DASO`` on
   ResNet-50 as 2 groups x 1, 8 images a rank, 8 steps (warmup 2,
   ``global_skip`` 4, ``stale_steps`` 1) against a one-process emulation of
   the same schedule, and ``consolidated_params`` against the ranks' mean;
   the communicators' traffic and transport (2 processes on ONE card, not a
   multi-card figure).
5. Holds the three flash-attention kernels against their plain versions,
   through the multi-head wrappers and through the grouped-query ones
   (query heads : K/V heads 8:2, 8:1 and 4:4): float32 and bfloat16, causal
   and full, d = 8, 33, 64, 100 and 128, ragged S (1000, 129) and S = 1024,
   and at the edges of the tiles (S = 1, 15, 64, 127); each row against
   that row's largest value, and in bfloat16 the share of elements that
   differ at all.  Below ~129 rows whole rows of dq and dk cancel to
   float32 noise, so at the edges the bfloat16 share of dq, dk and dv
   counts the elements above the row floor, and the float32 dq, dk and dv
   are held by the row error over the rows that reach the floor and by
   ``EDGE_F32_ATOL`` over the rows below it.  Every kernel twice to the
   same bits, the forward again with q and dq and dk/dv again with dO off
   16-byte alignment, to the same bits; d = 160 and 256 in every body
   (``FLASH_CHECKS``, ``GQA_CHECKS``, ``POS_CHECKS``), and the wide route
   past d = 256 (``csrc/flash_wide.cuh``, ``csrc/flash_wide_bwd.cuh``) at
   d = 257, 320, 384, 385, 512, 1024, 1025 and 1126 (``WIDE_DS``) in both
   dtypes through the multi-head, grouped and positions wrappers, to the
   same tolerances, each wrapper's launches at those shapes counted and
   every such d reported on the wide route by the C dispatch
   (``flash_attention.route``); there the float32 dq, dk and dv are held
   against the plain formulas in float64 (``wide_bwd_f64``), which no
   float32 sum order favours, and each line also gives the float32 plain
   versions' own error against it.  Every bfloat16
   launch runs a tensor-core body (``mma.sync``): the forward
   ``flash_fwd_tc.cuh``, dq and dk/dv ``flash_bwd_tc.cuh``; every float32
   launch the CUDA-core bodies of ``flash_f32.cuh``.
6. Trains ``TransformerLM(32768, 512, 8, depth=8, max_len=1024)`` (the
   width of the repo's LM benchmark) in float32 for 20 Adam steps on token
   batches (8, 1025) of repeated random segments: every flash kernel must
   launch 8 x 20 times, the grouped ones none, and the loss must fall.  Then
   one step through the kernels against one step through their plain
   versions (substituted here with ``unittest.mock.patch``), loss and every
   gradient.
7. Generates 448 tokens after a (8, 64) prompt with the weights in
   bfloat16, greedily: no flash kernel may launch.  Decoding is held against
   the bfloat16 forward over the prompt, which launches the forward kernel
   once per block.
8. Does 6 and 7 again for the grouped-query LM, the same width with
   ``num_kv_heads=2, positions="rope"`` (four query heads to a K/V head):
   its training launches each grouped kernel 8 x 20 times and the
   multi-head ones none, and it decodes from a cache of 2 K/V heads.
   After the bfloat16 training, one step of ``TransformerLM(32768, 1024, 2,
   depth=2)`` (head dim 512, ``LM_D512``) through the kernels against their
   plain versions: each multi-head kernel launches once a block, every
   launch on the wide route (``lm_d512_step``).
9. Holds the three positions kernels of ring attention's block against
   their plain versions: float32 and bfloat16, d = 8, 33, 64, 100 and 128,
   the ring step's diagonal, past and dead blocks at (B*H, Sq, Sk, d) =
   (16, 2048, 2048, 64) and ragged at (4, 300, 300), rectangular, ragged,
   one-row, one-key, pad-key and unmasked blocks, with a nonzero lse
   cotangent folded into dd; every kernel twice to the same bits, and again
   with k off 16-byte alignment.
10. Trains ``TransformerLM(32768, 512, 8, depth=8, max_len=4096, comm=comm)``
   sequence-parallel over 2 ranks: two spawned processes on this one card in
   a gloo group (NCCL refuses two ranks on one card; the ring's sends stage
   CUDA tensors through host memory), 20 float32 Adam steps on (2, 4097)-token
   batches, each rank holding 2048 positions.  Each positions wrapper must
   launch 8 x 20 x 2 times on each rank, the static ones none, and the
   loss must fall.  Then one ring step's loss and gradients against a
   world-1 step of the same weights on the card (the static flash
   kernels), and a ring step under the profiler on rank 0.  A child that
   fails, or does not report within the time limit, fails the run.
11. Trains the multi-head LM of 6 cast to bfloat16, 10 Adam steps on
   batches of 6's shape: each step launches each multi-head flash kernel 8
   times (the bfloat16 forward, dq and dk/dv on the tensor cores) and no
   other, and the loss must fall; the median step, the flash share of a
   profiled step, and one step through the kernels against one through
   their plain versions (loss and every gradient, ``BF16_STEP_*``).
11b. The rest of the nn surface (slice 17), at world size 1:
   ``Seq2SeqTransformer`` at transformer-base width (S2S_BASE: 6 + 6 blocks,
   d_model 512, d_ff 2048, 8 heads, dropout 0.1, 32768 tokens; 95 M
   parameters), 5 float32 Adam steps on (16, 256) synthetic source and
   target ids (a copy task), each step launching each multi-head flash
   kernel 18 times (6 encoder blocks, 6 decoder self- and 6 equal-length
   cross-attentions: ``flash_step_counts``) and the loss falling; one step
   against the plain attention (the gradients' scale floored at ROW_FLOOR
   of the largest: the cross-attention LayerNorms' are float32 noise of a
   cancelled sum); a target of 192 through the dense cross path against the
   plain attention; 64 greedy tokens and a width-4 beam search of 64, the
   greedy tokens the teacher-forced argmax over their prefix but at near
   ties (``greedy_agreement``).  The MoE LM (LM_MOE: 8 experts of the dense
   FFN's width, top-2, factor 1.25; 177 M parameters), 5 Adam steps on 6's
   batches with 0.01 x Switch's load-balance loss, the share of dropped
   claims each step, the peak memory beside 6's, 64 tokens generated
   through ``decode_apply``.  6's LM with ``remat=True`` against
   ``remat=False``, 2 steps (the forward launched twice a block), equal
   losses and gradients, the peak memory lower.  The layer families at
   users' sizes (``_layer_cases``), each forward and backward against
   float64 (the CPU's; LSTM and GRU the card's, their first rows the CPU's
   too) within LAYER_RTOL, the outputs on the card.  Then, in 10's spawned
   ranks (``nn_two_rank_cases``): the MoE LM at depth 2 with the ring and
   expert parallelism together (factor 4: nothing drops), ``Pipelined`` of
   8 transformer blocks on (16, 256, 512) in 4 microbatches and
   ``transformer_decoder`` over a (3, 2) split, each within NN_2R_RTOL of
   world size 1 on the card.
12. Times each kernel, its plain version and a library call at the main
   paths' shapes (CUDA events behind a device sleep, so the device's time
   and not Python's launch) and prints the ``kernels`` line, each flash
   row with the cores, the kernel and the source of its float32 and
   bfloat16 body (the multi-head rows also at the attention benchmark's
   shape, in both dtypes); each KMeans row with its products' instruction
   and the most warps resident on an SM, observed at the main shape by
   the kernels' residency counter (a ``kmeans_launch`` line a kernel and
   dtype gives the occupancy calculator's launch and the bound of the
   float32 FFMA design beside it).  The KMeans rows also carry the
   streamed route's times at 1e7 x 256, k = 64 (``KMEANS_WIDE``) and at
   1e7 x 128 past the caps, k = 417 (``KMEANS_PAST_CAP``); every flash
   row at head dim 256 in both dtypes (``d256_<dtype>``: ``FLASH_WIDE``,
   ``GQA_WIDE``, the ring blocks at ``POS_WIDE``) and at head dim 512, the
   wide route (``d512_<dtype>``: ``FLASH_D512``, ``GQA_D512``, the ring
   blocks at ``POS_D512``, with the wide route's errors there), with
   ``scaled_dot_product_attention`` as the library call and the backend
   that served it (``library_backend``, read from its kernels' names).
14. The serving tier (``serving_phase``): a stream of SERVE_JOBS jobs from
   three tenants (KMeans fits of 1e7 two-blob points, k = 2, 5 iterations;
   8192^2 matmul; 4096 triangular solves; ``nn_forward`` of width 1024,
   512 rows a job, stacked) offered to the scheduler on 2 gloo ranks of
   this card under the supervisor (``parallel.serve_world``), whose queue
   holds nine tenths of them (64), so the rest are shed at submit, as in
   the reference's serve scenario; rank 1 SIGKILLed at its SERVE_KILL
   dispatch, the world relaunched and recovered from rank 0's journal; and
   the DONE jobs at world size 1 in this process.  Every offered job is
   shed with its reason or ends DONE (or FAILED with a reason), none DONE
   before the kill runs again, every digest within SERVE_RTOL of world size
   1's, and the relaunched ranks' KMeans jobs launch assign and em_stats;
   its ``serving`` lines give jobs/s, p50 and p99 latency by kind, the
   recovery seconds, the launches and the largest digest error.  Before
   the stream, assign and em_stats are held against their plain versions
   on one KMeans job's own points at the shapes the jobs give them (1e7 x 2
   at world size 1, each rank's 5e6 x 2 at 2 ranks, k = 2).
15. The chaos scenarios (``chaos_phase``): the five specs of
   ``heat_tpu_torch.chaos.scenarios`` (kill-resume-train,
   serve-sigkill-mid-queue, hang-straggler-verdict on 2 ranks,
   desync-minority-verdict on 3, fed-world-kill), each a supervised world
   of ``chaos/world.py`` whose ranks run the port on this card over gloo,
   in two waves of worlds run at once (CHAOS_WAVES); each run must meet
   its spec's lines (``check_scenario``), and the post-mortem worlds'
   supervisor reports must carry the straggler and desync verdicts naming
   rank 1 under ``postmortems``.  Prints each scenario's seconds.
16. Ends with the line ``{"ok": true, "device": {...}}``.

The phases run in this order: 1, 2, 3, the world-size-1 parts of 3b, 4,
4b and 4c, then 5 to 9, 11, 11b's world-size-1 part and 12's timings,
then 3e; then the phases on spawned ranks, 10 first (with 11b's two-rank
part), then the 2-rank parts of 3b, 4, 4b and 4c; then 3c, 3d, 3f, 3g,
14 and 15.  Every check in this process that reads the profiler so runs before
the first spawned rank: after ranks on the card exit, CUPTI can record no
device activity for as long as it was watched (``profiled``, which also
starts CUPTI afresh for each session of this process).  Each profiled
check takes its session again at once while it records none (or, where it
reads the kmeans kernels, fewer launches than their wrappers counted), for
at most PROFILE_WAIT_S, and then fails; 10's rank 0 takes one session only.  The
script leaves by ``os._exit``, its output flushed.

Any failed check raises, so the script exits non-zero and prints no result
line.  Without CUDA it exits 2 at once.
"""

from __future__ import annotations

import json
import math
import os
import queue
import socket
import subprocess
import sys
import time
import traceback
import warnings

K, D = 64, 32
N_MAIN = 100_000_000
N_CHECK = 1_000_003
N_EM_CHECK = 999_983  # < N_CHECK: the rows past it are pad
N_PLUSPLUS = 1 << 22
MAX_ITER = 20

# H100 SXM rates (NVIDIA data sheet): float32 outside the tensor cores, bf16
# and TF32 dense tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# cuda_ms's device sleep: cycles a second at the H100's largest SM clock
# (1980 MHz; a lower clock only sleeps longer), at most 50 ms a timing
SLEEP_CYCLES_PER_S, SLEEP_MAX_S = 1.98e9, 0.05

# the LM of the repo's benchmark (bench.py, lm_generate): 59 M parameters, head dim 64
LM = dict(vocab_size=32768, embed_dim=512, num_heads=8, depth=8, max_len=1024)
LM_BATCH, LM_SEQ, LM_STEPS, LM_LR = 8, 1024, 20, 1e-3
LM_BF16_STEPS = 10  # the bfloat16 training phase: the MHA LM cast to bfloat16
LM_SEGMENT, LM_POOL = 32, 1024  # sequences repeat a random 32-token segment drawn from 1024 tokens
PROMPT, NEW_TOKENS = 64, 448
# the grouped-query LM: the same width, 2 K/V heads for the 8 query heads
# (Llama-3-8B's grouping, 32:8), rotary positions; 55.6 M parameters
LM_GQA = dict(LM, num_kv_heads=2, positions="rope")
FLASH_SOURCE = "heat_tpu_torch/ops/csrc/flash_attention.cu"
FWD_TC_SOURCE = "heat_tpu_torch/ops/csrc/flash_fwd_tc.cuh"  # the bfloat16 forward, included by FLASH_SOURCE
BWD_TC_SOURCE = "heat_tpu_torch/ops/csrc/flash_bwd_tc.cuh"  # the bfloat16 dq and dk/dv, included by FLASH_SOURCE
F32_SOURCE = "heat_tpu_torch/ops/csrc/flash_f32.cuh"  # the float32 forward, dq and dk/dv, included by FLASH_SOURCE
KMEANS_SOURCE = "heat_tpu_torch/ops/csrc/kmeans.cu"
WIDE_SOURCE = "heat_tpu_torch/ops/csrc/flash_wide.cuh"  # the wide route's forward, past d = 256
WIDE_BWD_SOURCE = "heat_tpu_torch/ops/csrc/flash_wide_bwd.cuh"  # its dq and dk/dv; all three in thread block clusters
# the kernel templates whose instances the ptxas lines report: the tensor-core
# bodies, the float32 bodies on the CUDA cores, the wide route, and the KMeans kernels
TC_KERNELS = {"flash_fwd_bf16_kernel": FWD_TC_SOURCE, "flash_bwd_dq_bf16_kernel": BWD_TC_SOURCE,
              "flash_bwd_dkv_bf16_kernel": BWD_TC_SOURCE}
F32_KERNELS = {"flash_fwd_f32_kernel": F32_SOURCE, "flash_bwd_dq_f32_kernel": F32_SOURCE,
               "flash_bwd_dkv_f32_kernel": F32_SOURCE}
WIDE_KERNELS = {"flash_wide_fwd_kernel": WIDE_SOURCE, "flash_wide_dq_kernel": WIDE_BWD_SOURCE,
                "flash_wide_dkv_kernel": WIDE_BWD_SOURCE}
KMEANS_KERNELS = {"assign_kernel": KMEANS_SOURCE, "em_stats_kernel": KMEANS_SOURCE,
                  "em_reduce_kernel": KMEANS_SOURCE}
MHA_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
GQA_KERNELS = ("flash_gqa_fwd", "flash_gqa_bwd_dq", "flash_gqa_bwd_dkv")
POS_KERNELS = ("flash_pos_fwd", "flash_pos_bwd_dq", "flash_pos_bwd_dkv")
# the sequence-parallel LM: the same width, 4096 positions over 2 ranks
LM_RING = dict(LM, max_len=4096)
RING_RANKS, RING_BATCH, RING_SEQ = 2, 2, 4096
# phase 11b: Seq2SeqTransformer at transformer-base width (Vaswani et al. 2017, Table 3 "base": N = 6,
# d_model 512, d_ff 2048, h = 8, P_drop 0.1), the LM phases' 32768 vocabulary for the paper's 37000
# shared BPE tokens: 95.0 M parameters; synthetic (16, 256) source and target ids (a copy task)
S2S_BASE = dict(src_vocab=32768, tgt_vocab=32768, embed_dim=512, num_heads=8, enc_depth=6, dec_depth=6,
                mlp_ratio=4, max_len=1024, dropout=0.1)
S2S_BATCH, S2S_SEQ, S2S_STEPS, S2S_SHORT, S2S_NEW, S2S_BEAM = 16, 256, 5, 192, 64, 4
S2S_LOGIT_RTOL = 1e-4  # the 192-target forward against the plain attention, of the largest logit
GREEDY_TIE_RTOL = 1e-4  # greedy vs the teacher-forced argmax: apart only within this share of the largest logit
# the MoE LM: the LM phases' width, 8 experts of the dense FFN's width, Switch-style top-2: 177 M parameters
LM_MOE = dict(LM, num_experts=8, moe_top_k=2, moe_capacity_factor=1.25)
MOE_STEPS, MOE_AUX, MOE_NEW = 5, 0.01, 64
REMAT_STEPS, REMAT_RTOL = 2, 1e-5  # remat against no remat: float32 rounding of the largest entry
LAYER_RTOL = 1e-4  # the layer families on the card against float64, of each tensor's largest magnitude
NN_2R_RTOL = 1e-4  # the two-rank MoE LM, pipeline and decoder against world size 1
RING_TIMEOUT_S = 600  # a child that has not reported by then fails the run
# the ring step's blocks at (B*H, Sq, Sk, d) = (16, 2048, 2048, 64), causal:
# name -> (query offset, key offset); over a layer's forward on both ranks
# the ring launches two diagonal blocks, one past and one dead
POS_MAIN = (16, 2048, 2048, 64)
POS_BLOCKS = {"diagonal": (2048, 2048), "past": (2048, 0), "dead": (0, 2048)}
POS_MIX = {"diagonal": 2, "past": 1, "dead": 1}
POS_WIDE = (16, 2048, 2048, 256)  # the ring step's blocks at head dim 256: the D = 256 bodies timed
POS_D512 = (16, 2048, 2048, 512)  # and at head dim 512: the wide route timed
# positions-kernel checks: (B, Sq, Sk, d, query offset, key offset, causal, s_valid)
POS_CHECKS = [(16, 2048, 2048, 64, 2048, 2048, True, 4096), (16, 2048, 2048, 64, 2048, 0, True, 4096),
              (16, 2048, 2048, 64, 0, 2048, True, 4096), (8, 1000, 600, 128, 300, 0, True, 1000),
              (8, 129, 1000, 64, 0, 0, False, 900), (8, 512, 512, 128, 0, 512, False, 2**30),
              (8, 200, 333, 64, 100, 50, True, 383),
              # the bfloat16 forward's edges: d off the 16-byte loads (33, 100) and tiny, one
              # row or key, and the ring's diagonal, past and dead blocks ragged at d = 100, 33, 8
              (4, 15, 127, 33, 100, 0, True, 227), (4, 1, 129, 8, 0, 0, False, 100),
              (4, 127, 1, 100, 200, 0, True, 201), (4, 300, 300, 100, 300, 300, True, 600),
              (4, 300, 300, 33, 300, 0, True, 600), (4, 300, 300, 8, 0, 300, True, 600),
              # the ring's diagonal, past and dead blocks at d = 256, ragged at d = 160
              (4, 300, 300, 256, 300, 300, True, 600), (4, 300, 300, 256, 300, 0, True, 600),
              (4, 300, 300, 256, 0, 300, True, 600), (4, 200, 333, 160, 100, 50, True, 383),
              # the wide route past d = 256: the ring's diagonal, past and dead blocks at d = 512,
              # ragged and rectangular at 257, unmasked at 320, the diagonal at 1126
              (4, 300, 300, 512, 300, 300, True, 600), (4, 300, 300, 512, 300, 0, True, 600),
              (4, 300, 300, 512, 0, 300, True, 600), (4, 200, 333, 257, 100, 50, True, 383),
              (4, 129, 300, 320, 0, 0, False, 2**30), (2, 300, 300, 1126, 300, 300, True, 600),
              (4, 200, 333, 384, 100, 50, True, 383), (4, 129, 300, 385, 0, 0, False, 2**30),
              (2, 300, 300, 1024, 300, 0, True, 600), (2, 200, 150, 1025, 100, 0, True, 240)]
# flash kernel checks: (query rows B*Hq, K/V rows B*Hkv, S, d, causal)
FLASH_CHECKS = [(16, 16, 1000, 64, True), (16, 16, 1000, 64, False), (16, 16, 129, 128, True),
                (16, 16, 129, 128, False), (64, 64, 1024, 64, True), (16, 16, 1024, 128, False),
                (16, 16, 1000, 33, True), (16, 16, 129, 8, False),
                # d past 128: the D = 256 tiles (one stage, dq's 32-row blocks, dk/dv's two passes)
                (16, 16, 1024, 256, True), (16, 16, 200, 160, False), (16, 16, 100, 96, True),
                # d past 256: the wide route (WIDE_DS), the d512 timings' shape among them
                (16, 16, 300, 257, True), (16, 16, 200, 320, False), (64, 64, 1024, 512, True),
                (16, 16, 129, 512, False), (8, 8, 333, 1126, True), (8, 8, 200, 1126, False),
                (8, 8, 200, 384, True), (8, 8, 129, 385, False), (8, 8, 300, 1024, True), (8, 8, 200, 1025, False)]
GQA_CHECKS = [(16, 4, 1000, 64, True), (16, 4, 1000, 64, False), (16, 2, 129, 128, True), (16, 2, 129, 128, False),
              (64, 16, 1024, 64, True), (64, 8, 1024, 64, False), (8, 8, 1024, 128, True), (8, 8, 1000, 64, False),
              (32, 4, 1000, 128, True), (16, 4, 1024, 256, True), (16, 2, 200, 160, False),
              (16, 4, 300, 257, False), (16, 2, 200, 320, True), (64, 16, 1024, 512, True), (8, 2, 333, 1126, True),
              (16, 4, 200, 384, False), (8, 2, 129, 385, True), (16, 4, 300, 1024, True), (8, 2, 200, 1025, True)]
WIDE_D = 256  # head dims past this run the wide route (flash_attention.route, checked in check_wide_launched)
# the head dims the wide route is held at, in every wrapper and both dtypes: where the backward's
# split changes (float32's 64-column chunks: clusters of 5 blocks at 257 and 320, 6 at 384, 7 at
# 385, 8 at 512, 2 passes of 8 at 1024, 3 passes of 6 at 1025 and 1126; bfloat16's 128-column
# chunks: 3, 3, 3, 4, 4, 8 blocks, then 2 passes of 5 at 1025 and 1126)
WIDE_DS = (257, 320, 384, 385, 512, 1024, 1025, 1126)
# the tiles' edges, through all three kernels: S of one row and under the
# 64-key and 128-row tiles; d = 33 and 100 load element by element, 8 pads one
# k16 step.  Below ~129 rows whole rows of dq and dk cancel to float32 noise
# (every row at S = 1: P = 1, O = V, so dP - dd = dO.V - dO.O is 0 but for
# the rounding of two sums; row 0 of a causal dq), whose bits depend on the
# order of the sums, so there the bfloat16 share of dq, dk and dv counts only
# the elements above the row floor (_share_above_floor) and the rest is held
# by the row error, as at every shape; the forward's counts every element.
# In float32 such a row's noise is not small against the row error's floor
# (ROW_FLOOR of the inputs' unit scale): summed over 8 heads at d = 128 it
# reaches 2.5e-6, 1.6 times FLASH_TOL's 2e-4 of the floor, on the plain
# versions alone (two sum orders of dd, CPU).  So at the edges the float32
# dq, dk and dv are held by _edge_err: a row whose plain value reaches the
# floor to FLASH_TOL's row error, a row below it to EDGE_F32_ATOL absolutely
FWD_EDGE_CHECKS = [(16, 16, 1, 8, True), (16, 16, 15, 33, False), (16, 16, 127, 100, True), (16, 16, 64, 64, True)]
# the wide route's edges, by the same criteria: one row, and under a tile at d = 257
WIDE_EDGE_CHECKS = [(16, 16, 1, 320, True), (16, 16, 127, 257, False)]
GQA_FWD_EDGE_CHECKS = [(16, 4, 127, 33, True), (16, 2, 15, 100, False), (32, 4, 1, 128, True)]
FLASH_MAIN = (64, 64, 1024, 64)  # the training step's attention: B*H = 8*8, S = 1024, d = 64, causal
GQA_MAIN = (64, 16, 1024, 64)  # the grouped LM's: 8 batches of 8 query and 2 K/V heads
FLASH_BENCH = (32, 32, 4096, 64)  # the repo's attention benchmark shape (bench.py, flash_attention_ab), causal bf16
FLASH_WIDE = (64, 64, 1024, 256)  # head dim 256 at the training step's rows and length: the D = 256 bodies timed
GQA_WIDE = (64, 16, 1024, 256)
FLASH_D512 = (64, 64, 1024, 512)  # head dim 512 at the training step's rows and length: the wide route timed
GQA_D512 = (64, 16, 1024, 512)
# one training step of an LM of head dim 512 (d_model 1024, 2 heads) through
# the wide route against the plain versions; two blocks keep it short
LM_D512 = dict(LM, embed_dim=1024, num_heads=2, depth=2)
# assign and em_stats at their edges: (rows, n, k, d, dtype, layout).  k from
# one cluster to past a 64-centre chunk, off the n8 tiles (1, 3, 9, 61,
# 127), and past what wgmma's centres hold in shared memory, so mma.sync
# takes the products (300 at d = 32; 64 at d = 128 in float32; 127 at d =
# 100 in bfloat16); d of one column, 8, off and on the 32-, 64- and
# 128-column tiles (33, 36, 100), up to 128; n of 0, 1, under one 32-row
# tile and off a block's tiles, and past the rows it is given; "blobs" keeps
# each cluster's rows contiguous, as create_clusters does (the fold's tiles
# hold one label), "shuffled" puts rows in random order (a run is about a
# row), and "dominant" gives one cluster 99% of 1e6 rows, a float32 running
# sum's longest chain; "+offset" starts x one element into its buffer, off
# 16-byte alignment, so the tiles are filled element by element
EM_EDGE_CHECKS = [(100_003, 99_991, 1, 32, "float32", "blobs"), (100_003, 100_003, 3, 32, "float32", "blobs"),
                  (100_003, 99_991, 61, 32, "float32", "shuffled"), (100_003, 99_991, 200, 32, "float32", "blobs"),
                  (100_003, 100_003, 64, 1, "float32", "shuffled"), (100_003, 99_991, 64, 33, "float32", "blobs"),
                  (100_003, 99_991, 64, 64, "float32", "shuffled"), (100_003, 99_991, 64, 100, "float32", "blobs"),
                  (100_003, 99_991, 64, 128, "float32", "shuffled"), (1000, 0, 64, 32, "float32", "blobs"),
                  (1000, 1, 64, 32, "float32", "blobs"), (1000, 50, 64, 32, "float32", "shuffled"),
                  (1000, 5000, 64, 32, "float32", "blobs"),
                  (1000, 777, 61, 33, "float32", "shuffled"), (777, 777, 3, 100, "float32", "blobs"),
                  (100_003, 99_991, 61, 100, "bfloat16", "shuffled"), (100_003, 99_991, 64, 32, "bfloat16", "blobs"),
                  (1_000_000, 1_000_000, 64, 32, "float32", "dominant"),
                  (1_000_000, 1_000_000, 64, 32, "bfloat16", "dominant"),
                  (100_003, 99_991, 9, 36, "float32", "shuffled"), (100_003, 99_991, 127, 100, "bfloat16", "blobs"),
                  (100_003, 99_991, 64, 8, "float32", "blobs"), (100_003, 99_991, 300, 32, "float32", "shuffled"),
                  (100_003, 99_991, 64, 32, "float32", "shuffled+offset"),
                  (100_003, 99_991, 64, 32, "bfloat16", "blobs+offset"), (1000, 20, 9, 32, "bfloat16", "shuffled"),
                  # the streamed route: d past 128, and k one centre past each kernel's cap
                  # (em_stats 862 / 208 and assign 1720 / 416 at d = 32 / 128 in float32,
                  # em_stats 216 at d = 128 in bfloat16), where a streamed em_stats'
                  # counts must equal a tiled assign's labels' bincount
                  (20_003, 19_991, 64, 129, "float32", "shuffled"), (20_003, 19_991, 61, 200, "float32", "blobs"),
                  (20_003, 19_991, 64, 256, "float32", "shuffled"), (20_003, 20_003, 64, 256, "bfloat16", "blobs"),
                  (20_003, 19_991, 9, 512, "float32", "shuffled"), (1000, 5000, 3, 256, "float32", "blobs"),
                  (20_003, 19_991, 209, 128, "float32", "shuffled"), (20_003, 19_991, 417, 128, "float32", "blobs"),
                  (20_003, 19_991, 863, 32, "float32", "shuffled"), (20_003, 19_991, 1721, 32, "float32", "blobs"),
                  (20_003, 19_991, 217, 128, "bfloat16", "shuffled"),
                  # the serving phase's KMeans jobs: two centres of width 2
                  (100_003, 100_003, 2, 2, "float32", "shuffled")]
# the serving phase (14): jobs, their sizes, the kill, the digests' tolerance
SERVE_JOBS = 72  # 64 accepted by the queue bound (serve_world.QUEUE_SHARE), 8 shed
SERVE_SIZES = dict(kmeans_n=10_000_000, matmul_n=8192, solve_n=4096, features=1024, batch=512)
SERVE_KILL = {"rank": 1, "site": "sched.dispatch", "at": 5}
SERVE_RTOL = 1e-5  # each digest against world size 1's: float32 sums in another order
# the streamed route's times for the KMeans rows: (n, d, k)
KMEANS_WIDE = (10_000_000, 256, 64)
KMEANS_PAST_CAP = (10_000_000, 128, 417)
DOMINANT_SHARE = 0.99
# kernel vs plain version, by _row_err (each row's largest error over that
# row's largest |plain|).  Both take P at the same running maximum over
# 64-key tiles and round at the same points, so they differ by float32 sum
# order: in float32 a few ulps of each term over <= 1024 keys (2e-4 on the
# gradients: row 0 of a causal dq cancels to 0 and keeps the float32
# rounding of dp - dd, ~1e-6 at d = 64, ~1e-4 of the row floor); in bfloat16
# the result rounds to bfloat16 (a step is <= 2^-7 of a value), and where
# the float32 scores differ in the last bits one P or dS may round one step
# apart too: 2^-6
FLASH_TOL = {"float32": {"out": 2e-5, "grad": 2e-4}, "bfloat16": {"out": 2.0**-6, "grad": 2.0**-6}}
ROW_FLOOR = 2.0**-7  # a row that cancels to ~0 keeps the rounding of its terms, of the tensor's or inputs' scale
# float32 at the edges (_edge_err): the absolute error of a dq, dk or dv row
# whose plain value stays below the row floor.  Such a row is float32 noise
# of a cancelled sum; at unit-scale inputs it stays within 2.5e-6 (S = 1,
# 8 heads to a K/V head, d = 128, two sum orders of dd on the plain
# versions), and 2^-16 = 1.5e-5 leaves six times that, while one bfloat16
# step of a value at the floor (2^-7 * 2^-7 = 6.1e-5) is four times over it
EDGE_F32_ATOL = 2.0**-16
# bfloat16: the share of out, dq, dk, dv elements that differ at all.  With
# P and dS rounded at the same points, a result differs only where float32
# sum order carries it across a bfloat16 rounding boundary (~1e-4 of them);
# rounding P at another maximum (the whole row's, not the running one over
# 64-key tiles) moves 5-24% of them (CPU runs of the plain version).  At the
# edge shapes the share of dq, dk and dv counts the elements above the row
# floor only (see FWD_EDGE_CHECKS): those that are float32 noise of a sum
# that cancels are held by the row error instead
BF16_DIFF_SHARE = 0.01
# ... and past d = 256 (the wide route), BF16_DIFF_SHARE * sqrt(d / 256).
# There the share grows with d: a score sums d products, the tensor cores
# add them in 16-term groups and the plain version's float32 product in a
# sequential chain, so the two scores differ by ~sqrt(d) float32 ulps (a
# unit-scale score after the d^-1/2 scale) and a P or dS rounds to the other
# side of a bfloat16 boundary in proportion: the d <= 256 limit, scaled by
# that growth from d = 256.  Largest shares read on an H100 (NVIDIA H100
# 80GB HBM3, 700 W), of out, dq, dk, dv over every shape at each d: 0.50%
# at d = 256, 0.44% at 257, 0.48% at 320, 0.91% at 512, 1.11% at 1126,
# against limits of 1%, 1.00%, 1.12%, 1.41% and 2.10%; the row error stays
# held to FLASH_TOL's 2^-6 at every d


def bf16_share_limit(d: int) -> float:
    """The bfloat16 differing share a shape of head dim ``d`` is held to."""
    return BF16_DIFF_SHARE * math.sqrt(max(d, WIDE_D) / WIDE_D)


LSE_ATOL = 2e-5  # lse is float32 in both dtypes, of magnitude ~log(S) + |s|: a few float32 ulps
# one training step through the kernels vs through the plain versions
# (float32): loss to 1e-5 relative; each parameter's gradient to 1e-3 of its
# largest entry (the attention outputs differ by float32 rounding, ~1e-6,
# and the 8 blocks' backward carries that through GEMMs and LayerNorms)
STEP_LOSS_RTOL, STEP_GRAD_RTOL = 1e-5, 1e-3
# the same in bfloat16 (weights, activations, the loss and the gradients
# bfloat16): the attention's outputs and gradients round to bfloat16 on both
# sides and may round a step apart, carried through 8 blocks.  Set from the
# CUDA-core bfloat16 backward that the tensor-core one replaced, in this
# comparison on an H100 (PERF.md §6): its loss agreed exactly and its
# worst gradient to 0.0076 of its largest entry, one bfloat16 step (2^-7).
# Held to one step of the loss and two of a gradient's largest entry
BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_RTOL = 2.0**-7, 2.0**-6
# bfloat16 decoding vs the bfloat16 forward: every activation rounds to
# bfloat16 (2^-8) in both, in another order (einsum + softmax against the
# flash kernel's float32 accumulation), over 8 residual blocks and the
# 32768-wide head: logits agree to 5% of their largest magnitude
DECODE_RTOL = 0.05

TIE_RTOL = 1e-5  # a label may differ where the plain top-2 gap is <= TIE_RTOL * |x|^2
D2_RTOL = 1e-5  # |d2 - plain d2| <= D2_RTOL * (|x|^2 + |c|^2): float32 rounding of the expansion
SUM_RTOL = 1e-5  # em sums vs. an exact float64 scatter of the same labels
# ht.matmul (BASELINE config 0): square float32 products split 0 x split 0 at
# BASELINE's 4096 and the north star's 16384 (3 GiB for a, b and the result);
# the two-rank phase at 4096 and SUMMA at a ragged shape too
MATMUL_SIZES = (4096, 16384)
MATMUL_RTOL = 1e-5  # max |C - C64| / max |C64|: full float32 (TF32 products give ~1e-3)
MATMUL_2R, MATMUL_RAGGED = 4096, (4099, 4097, 4095)
MATMUL_2R_RTOL = 1e-5  # the same measure against world size 1: partial products over K halves summed
# the JAX package's result splits of the two-rank cases (heat_tpu/linalg/basics.py::_matmul_result_split)
MATMUL_SPLITS = {"None,None": None, "0,None": 0, "1,None": 0, "None,0": 1, "None,1": 1, "0,0": 0, "0,1": 0,
                 "1,0": 1, "1,1": 1, "vector @ matrix 0,1": 0, "matrix @ vector 1,0": None}
MATMUL_COLLECTIVES = ("Allreduce", "Allgather", "Alltoall", "ReduceScatter", "Bcast", "Reduce", "Scatter", "Gather",
                      "Send", "Exscan", "Scan")
# the indexing phase: X of BASELINE config 2's shape (1e8 x 32 float32, split
# 0; X[idx] picks INDEX_PICK random rows) and A of config 0's (16384^2 float32,
# split 0 and 1); a read costs whole 32-byte sectors
INDEX_PICK, INDEX_A, SECTOR = 1_000_000, 16384, 32
# the JAX package's result splits (heat_tpu/core/dndarray.py::_result_split_of_key,
# heat_tpu/core/indexing.py) of the phase's operations, "<operation> @ <the source's split>"
INDEX_SPLITS = {"X[idx] @ 0": 0, "X[::2] @ 0": 0, "X[::-1] @ 0": 0, "X[:, 3] @ 0": 0, "X[m] @ 0": 0,
                "X[m] = 0 @ 0": 0, "X[idx] = Y @ 0": 0, "where(X > 0, X, 0) @ 0": 0, "nonzero(m) @ 0": 0,
                "A[:, 100:200] @ 0": 0, "A[:, 100:200] @ 1": 1, "A[5] @ 0": None, "A[5] @ 1": 0,
                "A[:, ::2] @ 0": 0, "A[:, ::2] @ 1": 1, "A[A < 0] = 0 @ 1": 1, "A.fill_diagonal(0) @ 0": 0,
                "A.fill_diagonal(0) @ 1": 1, "identity @ 0": 0, "tri @ 0": 0, "vander @ 0": 0}
STR_EDGE_BYTES = 4096  # str(X) may copy its 7 x 7 edges to the host, never more than this
# phase 3c: the statistics, order and reshape ops at world size 1 (X = rand(N_MAIN, D), v = rand(STATS_V),
# w = randint(0, STATS_UNIQUE_HIGH, STATS_V)); each result's split is the JAX package's
STATS_SEED, STATS_V, STATS_PREFIX, STATS_TOPK, STATS_QUERIES = 14, 1_000_000_000, 1_000_000, 1000, 1_000_000
STATS_UNIQUE_HIGH, STATS_PAD = 1_000_000, 8
STATS_RTOL = 1e-5  # max |got - float64| / max |float64|
STATS_2R_SORT, STATS_2R_RTOL, STATS_2R_STRIDE = 10_000_000, 1e-5, 9973
PEAK_FP32 = 67e12  # an H100 SXM's float32 rate outside the tensor cores
PROFILE_WAIT_S = 60.0  # how long ``profiled`` takes a session again while sessions record no device activity
_TEARDOWN_CUPTI = False  # main() sets it: this process's profiler sessions each start CUPTI afresh
STATS_SPLITS = {
    "rand": 0, "randn": 0, "randint": 0,
    **{f"{op}(X, 0)": None for op in ("mean", "var", "std", "argmax")},
    **{f"{op}(X, 1)": 0 for op in ("mean", "var", "std", "argmax")},
    **{f"{op}(X)": None for op in ("mean", "var", "std", "argmax")},
    "cov(X, rowvar=False)": None, "histogram(X[:, 0], 100)": None,
    "sort(v)": 0, "argsort(v)": 0, "percentile(v, [5, 50, 95])": None, "median(v)": None, "topk(v, 1000)": None,
    "searchsorted(v, q)": None, "unique(w)": 0,
    "reshape(X, (5e7, 64))": 0, "concatenate(X halves)": 0, "roll(X, 1000, 0)": 0, "pad(A, 8)": 0,
    "einsum('ij,ik->jk', X, X)": None, "kron(a, b)": 0, "det(M)": None, "inv(M)": 0,
}
# the two-rank indexing phase: ragged arrays on HeAT's uneven chunks, with their splits
INDEX_2R = {"rows": ((1001, 7), (0,)), "cols": ((7, 1001), (1,)), "cube": ((13, 6, 5), (0, 1, 2))}
# tall-skinny QR/SVD (BASELINE config 1): float32 randn 1e6 x 256, split=0, at full size
QR_SHAPE = (1_000_000, 256)
QR_TOL = 1e-4  # the reference's tests' limits (tests/test_linalg.py): ||A - QR|| / ||A||, |Q^T Q - I|, S
QR_CHECK_ROWS = 1 << 17  # rows a block of the float64 checks
SOLVE_N = 4096  # solve_triangular and cg on an SPD system of this size
SOLVE_RTOL = 1e-4  # max |x - x64| / max |x64|
# cdist at KMeans' width: x, y 32768 x 32 float32, split=0 (a 4 GiB result)
CDIST_SHAPE = (32768, 32)
CDIST_SAMPLE = 256  # rows held against float64
CDIST_RTOL = 1e-5  # the direct form, manhattan: |d - d64| <= CDIST_RTOL * d64
CDIST_EXPANSION_ATOL = 1e-4  # the quadratic expansion: |d - d64| <= this times the largest distance
RBF_SIGMA = 8.0  # sqrt(2d): exp(-d^2 / 2 sigma^2) of randn rows is near e^-1/2, spread over (0, 1]; held by CDIST_RTOL
# the two-rank linear algebra phase: ragged shapes, each against world size 1 on the card
LINALG_2R_TOL = 1e-5  # max |got - want| / max |want|, factors sign-aligned
LINALG_2R_CDIST = ((1001, 32), (777, 32))
LINALG_2R_QR, LINALG_2R_REPLICATED = (4099, 64), (100, 64)
# the data-parallel phase (4c): BASELINE config 3 (the MNIST MLP) and config 4 (ResNet-50)
MNIST_N, MNIST_BATCH, MNIST_EPOCHS, MNIST_LR, MNIST_ACC = 60000, 256, 3, 1e-3, 0.9
R50_BATCH, R50_STEPS, R50_LR, R50_MOMENTUM, R50_CLASSES = 64, 20, 0.05, 0.9, 1000
DP_2R_MLP_ROWS, DP_2R_R50_ROWS = 257, 8  # the MLP's ragged global batch; ResNet-50's rows a rank
DASO_2R = dict(total_local_comm_size=1, warmup_steps=2, global_skip=4, stale_steps=1)  # 2 groups x 1
DASO_2R_STEPS = 8
DP_2R_RTOL = 1e-5  # max |got - want| / max |want| of the loss and every parameter, IEEE float32
# ResNet-50's parameters after the two-rank step are held in float64: in float32 the world-1 step
# itself lies ~7e-2 (relative) from the float64 step on BatchNorm biases whose gradients cancel
# (measured on the CPU at 224^2, 16 images), and the two-rank step as far
DP_2R_F64_RTOL = 1e-9
CONV_WORDS = ("conv", "fprop", "dgrad", "wgrad", "winograd", "cudnn", "implicit")  # cuDNN's convolution kernels
RECOVER_TOL = 0.05  # kmeans++ fits: distance of each generating mean to its fitted centre
INERTIA_RTOL = 1e-6  # the fit's inertia may pass the one-step inertia by float64 sum rounding only


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """ms of one call of ``fn`` on the card: ``reps`` calls between two CUDA
    events, queued behind a device sleep that outlasts their launch on the
    host, so the events time the device's work back to back and not the
    host's (a call whose kernels take less than its Python takes to launch
    them would otherwise time the Python)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0  # one call's launch, or its whole run where it waits on the card
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(2 * reps * host_s, SLEEP_MAX_S) * SLEEP_CYCLES_PER_S))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kmeans_bytes(n: int, itemsize: int, em: bool, d: int = D, k: int = K) -> int:
    """Bytes a KMeans kernel moves once on n rows: x, the centres, and its
    outputs (labels and d2, or the sums and counts)."""
    return n * d * itemsize + k * d * 4 + ((k * d + k) * 4 if em else n * 8)


def bound(n: int, itemsize: int, em: bool, d: int = D, k: int = K):
    """(bound_ms, bound_by) of a KMeans kernel on n rows: the larger of the
    bytes moved once over the HBM rate and the split-TF32 products over the
    TF32 tensor-core rate (three products of 2nkd FLOP for float32 x, two
    for bfloat16 x, which TF32 holds exactly)."""
    t_bytes = _kmeans_bytes(n, itemsize, em, d, k) / PEAK_BYTES
    t_ops = (3 if itemsize == 4 else 2) * 2 * n * k * d / PEAK_TF32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ffma_bound(n: int, itemsize: int, em: bool) -> float:
    """The KMeans kernels' bound before their products moved to the tensor
    cores, in ms: the bytes against the same work as float32 FFMAs (the
    products and, for em_stats, the nd adds of its sums)."""
    t_ffma = (2 * n * K * D + (n * D if em else 0)) / PEAK_F32_FLOPS
    return max(_kmeans_bytes(n, itemsize, em) / PEAK_BYTES, t_ffma) * 1e3


def compare_assign(x, c, lab_k, d2_k, lab_p, d2_p):
    """(mismatches, near-tie mismatches, max |d2 err|); raises past the tolerances."""
    import torch

    from heat_tpu_torch.ops import kmeans_kernels as kk

    xx = torch.linalg.vector_norm(x, dim=1, dtype=torch.float32).square()
    cc = (c * c).sum(1)
    err = (d2_k - d2_p).abs()
    scale = xx + cc[lab_p.long()]
    if bool((err > D2_RTOL * scale).any()):
        i = int((err - D2_RTOL * scale).argmax())
        fail(f"d2 row {i}: kernel {float(d2_k[i])} plain {float(d2_p[i])}")
    rows = (lab_k != lab_p).nonzero()[:, 0]
    ties = 0
    if rows.numel():
        dd = torch.cat([db for _, _, db, _ in kk.sq_dist_blocks(x[rows], c)])
        top2 = dd.topk(2, dim=1, largest=False).values
        gap = top2[:, 1] - top2[:, 0]
        far = gap > TIE_RTOL * xx[rows]
        if bool(far.any()):
            fail(f"{int(far.sum())} labels differ beyond a near tie")
        ties = int(rows.numel())
    return int(rows.numel()), ties, float(err.max())


def compare_em(x, c, n, sums_k, counts_k, lab_k, sums_p, counts_p, ties):
    """Counts exactly those of the kernel's own labels; sums against a float64
    scatter of those labels; plain version within the near-tie allowance.
    Returns (max abs error against the plain version, against the float64 scatter)."""
    import torch

    k, d = c.shape
    lab = lab_k[:n].long()
    want_counts = torch.bincount(lab, minlength=k).float()
    if not torch.equal(counts_k, want_counts):
        fail("em_stats counts differ from the assign kernel's labels")
    want = torch.zeros((k, d), dtype=torch.float64, device=x.device)
    mag = torch.zeros((k, d), dtype=torch.float64, device=x.device)
    for s in range(0, n, 1 << 22):
        xb = x[s : min(s + (1 << 22), n)].double()
        want.index_add_(0, lab[s : s + xb.shape[0]], xb)
        mag.index_add_(0, lab[s : s + xb.shape[0]], xb.abs())
    exact_err = (sums_k.double() - want).abs()
    if bool((exact_err > SUM_RTOL * mag + 1e-6).any()):
        fail(f"em_stats sums off by {float(exact_err.max())} from a float64 scatter")
    exact = float(exact_err.max())
    dc = float((counts_k - counts_p).abs().sum())
    if dc > 2 * ties:
        fail(f"em_stats counts differ from the plain version by {dc} beyond {ties} near ties")
    err = (sums_k - sums_p).abs()
    xmax = max(abs(float(x[:n].max())), abs(float(x[:n].min()))) if n else 0.0
    allow = SUM_RTOL * mag.float() + 2 * ties * xmax + 1e-4
    if bool((err > allow).any()):
        fail(f"em_stats sums differ from the plain version by {float(err.max())}")
    return float(err.max()), exact


def em_edge_inputs(rows: int, k: int, d: int, dtype: str, layout: str, seed: int, device="cuda"):
    """(x (rows, d) in ``dtype``, centres (k, d) float32) for an edge check:
    Gaussian blobs (sd 0.7) around centres of sd 4, each cluster's rows
    contiguous ("blobs"), in random order ("shuffled"), or DOMINANT_SHARE of
    them in cluster 0, first and contiguous, at a centre of magnitude ~20 per
    column ("dominant"), where a float32 running sum of the cluster drifts
    most.  A layout ending in "+offset" gives the same x as a contiguous view
    one element into a flat buffer: off 16-byte alignment."""
    import torch

    layout, _, shift = layout.partition("+")
    g = torch.Generator(device=device).manual_seed(seed)
    c = torch.randn((k, d), generator=g, device=device) * 4.0
    if layout == "dominant":
        c[0] += 20.0
        big = int(rows * DOMINANT_SHARE)
        lab = torch.cat([torch.zeros(big, dtype=torch.int64, device=device),
                         torch.randint(0, k, (rows - big,), generator=g, device=device)])
    else:
        lab = torch.randint(0, k, (rows,), generator=g, device=device)
        if layout == "blobs":
            lab = lab.sort().values
    x = (c[lab] + 0.7 * torch.randn((rows, d), generator=g, device=device)).to(getattr(torch, dtype))
    if shift == "offset":
        buf = torch.empty(rows * d + 1, dtype=x.dtype, device=device)
        buf[1:] = x.flatten()
        x = buf[1:].view(rows, d)
    return x.contiguous(), c.contiguous()


def check_em_edges(edges=EM_EDGE_CHECKS) -> None:
    """assign and em_stats at their edge shapes: assign against its plain
    version (compare_assign: d2 within D2_RTOL, a label that differs only
    at a near tie within TIE_RTOL), em_stats against its plain version and
    the float64 scatter of assign's labels (compare_em), each twice to the
    same bits."""
    import torch

    from heat_tpu_torch.ops import kmeans_kernels as kk

    for rows, n, k, d, dtype, layout in edges:
        shape = (rows, n, k, d, dtype, layout)
        x, c = em_edge_inputs(rows, k, d, dtype, layout, seed=rows + n + k + d)
        sums, counts = kk.fused_em_stats(x, c, n)
        sums2, counts2 = kk.fused_em_stats(x, c, n)
        lab, d2 = kk.fused_assign(x, c)
        lab2, d22 = kk.fused_assign(x, c)
        sums_p, counts_p = kk._torch_em_stats(x, c, n)
        lab_p, d2_p = kk._torch_assign(x, c)
        torch.cuda.synchronize()
        if not (torch.equal(sums, sums2) and torch.equal(counts, counts2)):
            fail(f"em_stats does not repeat its bits at {shape}")
        if not (torch.equal(lab, lab2) and torch.equal(d2, d22)):
            fail(f"assign does not repeat its bits at {shape}")
        if tuple(sums.shape) != (k, d) or tuple(counts.shape) != (k,) or float(counts.sum()) != min(n, rows):
            fail(f"em_stats at {shape}: shapes {tuple(sums.shape)}, {tuple(counts.shape)}, {float(counts.sum())} rows")
        mism, near, d2_err = compare_assign(x, c, lab, d2, lab_p, d2_p)
        ties = int((lab[:n] != lab_p[:n]).sum())
        err, exact = compare_em(x, c, n, sums, counts, lab, sums_p, counts_p, ties)
        print(json.dumps({"phase": "kernel_check", "kernel": "assign+em_stats", "edge": True, "rows": rows, "n": n,
                          "k": k, "d": d, "dtype": dtype, "layout": layout,
                          "products": kk.launch_config(k, d, x.dtype)["products"],
                          "assign_max_abs_err": d2_err, "label_mismatches": mism, "near_ties": near,
                          "max_abs_err": err, "max_abs_err_vs_float64": exact, "em_near_ties": ties,
                          "sum_rtol": SUM_RTOL, "repeats_bitwise": True, "check": "pass"}), flush=True)


def check_kernels_small(dtype) -> None:
    import torch

    from heat_tpu_torch.cluster import KMeans
    from heat_tpu_torch.ops import kmeans_kernels as kk

    g = torch.Generator(device="cuda").manual_seed(1)
    x = (torch.randn((N_CHECK, D), generator=g, device="cuda") * 3.0).to(dtype)
    c = x[torch.randperm(N_CHECK, generator=g, device="cuda")[:K]].float().contiguous()
    lab_k, d2_k = kk.fused_assign(x, c)
    lab_p, d2_p = kk._torch_assign(x, c)
    torch.cuda.synchronize()
    mism, ties, d2_err = compare_assign(x, c, lab_k, d2_k, lab_p, d2_p)
    sums_k, counts_k = kk.fused_em_stats(x, c, N_EM_CHECK)
    sums_k2, counts_k2 = kk.fused_em_stats(x, c, N_EM_CHECK)
    if not (torch.equal(sums_k, sums_k2) and torch.equal(counts_k, counts_k2)):
        fail("em_stats is not deterministic")
    sums_p, counts_p = kk._torch_em_stats(x, c, N_EM_CHECK)
    tie_rows = int((lab_k[:N_EM_CHECK] != lab_p[:N_EM_CHECK]).sum())
    em_err, em_exact = compare_em(x, c, N_EM_CHECK, sums_k, counts_k, lab_k, sums_p, counts_p, tie_rows)
    name = str(dtype).replace("torch.", "")
    xl = x[:N_EM_CHECK]
    for kernel, run, plain, lib, err, extra in (
        ("assign", lambda: kk.fused_assign(x, c), lambda: kk._torch_assign(x, c),
         lambda: KMeans._assign(x, c), d2_err, {"label_mismatches": mism, "near_ties": ties}),
        ("em_stats", lambda: kk.fused_em_stats(x, c, N_EM_CHECK), lambda: kk._torch_em_stats(x, c, N_EM_CHECK),
         lambda: KMeans._blocked_stats(xl, c), em_err,
         {"count_diff": float((counts_k - counts_p).abs().sum()), "max_abs_err_vs_float64": em_exact}),
    ):
        print(json.dumps({
            "phase": "kernel_check", "kernel": kernel, "dtype": name, "n": N_CHECK, "k": K, "d": D,
            "max_abs_err": err, **extra, "ms": cuda_ms(run, 10), "plain_ms": cuda_ms(plain, 3),
            "library_ms": cuda_ms(lib, 3), "check": "pass",
        }), flush=True)


def main_fit(ht, x, label: str, init="random"):
    """One KMeans fit and predict through the public API, counts zeroed just
    before; returns the estimator, the launch counts and the printed row."""
    import torch

    from heat_tpu_torch.ops import kmeans_kernels as kk

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in kk.launch_counts:
        kk.launch_counts[key] = 0
    t0 = time.perf_counter()
    km = ht.cluster.KMeans(n_clusters=K, init=init, max_iter=MAX_ITER, random_state=0).fit(x)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    pred = km.predict(x)
    torch.cuda.synchronize()
    counts = dict(kk.launch_counts)
    centers = km.cluster_centers_.larray.float()
    if tuple(centers.shape) != (K, D) or not bool(torch.isfinite(centers).all()):
        fail(f"{label}: centres are not finite (k, d)")
    if not (km.inertia_ == km.inertia_ and km.inertia_ < float("inf")):
        fail(f"{label}: inertia is not finite")
    if counts["em_stats"] != km.n_iter_ or counts["assign"] < 2:
        fail(f"{label}: launches {counts} do not show the kernels on the path (n_iter {km.n_iter_})")
    if not torch.equal(pred.larray, km.labels_.larray):
        fail(f"{label}: predict disagrees with the fit's labels")
    labels = km.labels_.larray
    if int(labels.min()) < 0 or int(labels.max()) >= K:
        fail(f"{label}: labels out of range")
    row = {
        "phase": "main_path", "fit": label, "n": x.shape[0], "d": D, "k": K, "dtype": str(x.dtype.__name__),
        "init": init, "n_iter": km.n_iter_, "inertia": km.inertia_, "fit_s": fit_s,
        "fit_iter_per_s": km.n_iter_ / fit_s, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launch_counts": counts,
    }
    print(json.dumps(row), flush=True)
    return km, counts, row


def recovered(centers, means, tol: float) -> int:
    dist = ((means[:, None, :] - centers[None, :, :]) ** 2).sum(-1).sqrt().min(1).values
    return int((dist <= tol).sum())


def recover(ht, x, means, label: str) -> None:
    """A kmeans++ fit must put a centre within RECOVER_TOL of every generating mean."""
    kp, _, _ = main_fit(ht, x, label, init="kmeans++")
    got = recovered(kp.cluster_centers_.larray.float(), means, RECOVER_TOL)
    print(json.dumps({"phase": "main_path_recovery", "fit": label, "init": "kmeans++", "means_within_tol": got,
                      "tol": RECOVER_TOL, "held": True}), flush=True)
    if got != K:
        fail(f"{label}: recovered {got} of {K} generating means within {RECOVER_TOL}")


def compare_with_torch_path(ht, x, km, label: str, atol: float, rtol: float) -> None:
    """One Lloyd step from the same random init through the kernels and through
    the torch path must give the same centres and inertia, and the fit ``km``
    from that init an inertia no higher.  (Whole fits from a random init are
    not compared: where two centres split one blob, the split direction
    drifts freely and float rounding alone steers it.)"""
    fits = [
        ht.cluster.KMeans(n_clusters=K, init="random", max_iter=1, random_state=0, assign_kernel=kernel).fit(x)
        for kernel in ("pallas", "jnp")
    ]
    a, b = (f.cluster_centers_.larray.float() for f in fits)
    err = float((a - b).abs().max())
    if not bool(((a - b).abs() <= atol + rtol * b.abs()).all()):
        fail(f"{label}: one step's centres differ from the torch path's by {err}")
    if abs(fits[0].inertia_ - fits[1].inertia_) > 1e-4 * abs(fits[1].inertia_):
        fail(f"{label}: inertia {fits[0].inertia_} vs torch path {fits[1].inertia_}")
    if km.inertia_ > fits[0].inertia_ * (1.0 + INERTIA_RTOL):
        fail(f"{label}: {km.n_iter_} steps end at inertia {km.inertia_}, above one step's {fits[0].inertia_}")
    print(json.dumps({"phase": "one_step_vs_torch_path", "fit": label, "max_abs_centre_err": err,
                      "inertia": fits[0].inertia_, "torch_path_inertia": fits[1].inertia_,
                      "fit_inertia": km.inertia_,
                      "atol": atol, "rtol": rtol}), flush=True)


def check_at_main_shape(x, c, label: str):
    """Both kernels against their plain versions on the main path's data and
    fitted centres; returns each kernel's max abs error."""
    from heat_tpu_torch.ops import kmeans_kernels as kk

    n = x.shape[0]
    lab_k, d2_k = kk.fused_assign(x, c)
    lab_p, d2_p = kk._torch_assign(x, c)
    mism, ties, d2_err = compare_assign(x, c, lab_k, d2_k, lab_p, d2_p)
    sums_k, counts_k = kk.fused_em_stats(x, c)
    sums_p, counts_p = kk._torch_em_stats(x, c, n)
    em_err, em_exact = compare_em(x, c, n, sums_k, counts_k, lab_k, sums_p, counts_p, ties)
    print(json.dumps({"phase": "kernel_check_main_shape", "dtype": label, "n": n, "label_mismatches": mism,
                      "near_ties": ties, "assign_max_abs_err": d2_err, "em_stats_max_abs_err": em_err,
                      "em_stats_max_abs_err_vs_float64": em_exact,
                      "count_diff": float((counts_k - counts_p).abs().sum()), "check": "pass"}), flush=True)
    return {"assign": (d2_err, None), "em_stats": (em_err, em_exact)}


def time_kernels(x, c, launches, err):
    """Kernel, plain and torch-path times at the main path's shapes; one entry per kernel."""
    from heat_tpu_torch.cluster import KMeans
    from heat_tpu_torch.ops import kmeans_kernels as kk

    n, itemsize = x.shape[0], x.element_size()
    rows = []
    for name, run, plain, lib, em, line in (
        ("assign", lambda: kk.fused_assign(x, c), lambda: kk._torch_assign(x, c),
         lambda: KMeans._assign(x, c), False, 67),
        ("em_stats", lambda: kk.fused_em_stats(x, c), lambda: kk._torch_em_stats(x, c, n),
         lambda: KMeans._blocked_stats(x, c), True, 111),
    ):
        b_ms, b_by = bound(n, itemsize, em)
        rows.append({
            "name": name, "route": "cuda", "source": KMEANS_SOURCE,
            "replaces": f"heat_tpu/ops/kmeans_kernels.py:{line}", "launches": launches[name],
            "max_abs_err": err[name][0], "max_abs_err_vs_float64": err[name][1],
            "ms": cuda_ms(run, 5), "plain_ms": cuda_ms(plain, 2),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(lib, 2), "check": "pass",
        })
    return rows


def time_kmeans_streamed() -> dict:
    """The KMeans kernels' streamed route in float32 at KMEANS_WIDE (d past
    the tiles) and KMEANS_PAST_CAP (k past both kernels' caps): each held
    against its plain version (compare_assign, compare_em) and timed beside
    its bound, the plain version and the torch path.  Returns {kernel:
    {"d256": {...}, "past_cap_k": {...}}} for the kernels line."""
    import torch

    from heat_tpu_torch.cluster import KMeans
    from heat_tpu_torch.ops import kmeans_kernels as kk

    out = {"assign": {}, "em_stats": {}}
    for label, (n, d, k) in (("d256", KMEANS_WIDE), ("past_cap_k", KMEANS_PAST_CAP)):
        x, c = em_edge_inputs(n, k, d, "float32", "blobs", seed=d + k)
        lab, d2 = kk.fused_assign(x, c)
        lab_p, d2_p = kk._torch_assign(x, c)
        mism, ties, d2_err = compare_assign(x, c, lab, d2, lab_p, d2_p)
        del lab_p, d2_p
        sums, counts = kk.fused_em_stats(x, c)
        sums_p, counts_p = kk._torch_em_stats(x, c, n)
        em_err, em_exact = compare_em(x, c, n, sums, counts, lab, sums_p, counts_p, ties)
        for name, run, plain, lib, em, err in (
            ("assign", lambda: kk.fused_assign(x, c), lambda: kk._torch_assign(x, c),
             lambda: KMeans._assign(x, c), False, d2_err),
            ("em_stats", lambda: kk.fused_em_stats(x, c), lambda: kk._torch_em_stats(x, c, n),
             lambda: KMeans._blocked_stats(x, c), True, em_err),
        ):
            b_ms, b_by = bound(n, x.element_size(), em, d, k)
            out[name][label] = {"n": n, "d": d, "k": k, "dtype": "float32",
                                "route": kk.launch_config(k, d, x.dtype, em=em)["route"], "max_abs_err": err,
                                "ms": cuda_ms(run, 5), "plain_ms": cuda_ms(plain, 2), "bound_ms": b_ms,
                                "bound_by": b_by, "library_ms": cuda_ms(lib, 2)}
        print(json.dumps({"phase": "kernel_check_streamed", "n": n, "d": d, "k": k, "label_mismatches": mism,
                          "near_ties": ties, "em_stats_max_abs_err_vs_float64": em_exact,
                          "assign": out["assign"][label], "em_stats": out["em_stats"][label], "check": "pass"}),
              flush=True)
        del x, c, lab, d2, sums, counts, sums_p, counts_p
        torch.cuda.empty_cache()
    return out


def kmeans_launch(x, c) -> dict:
    """Each KMeans kernel's launch at the main path's shape, by name: its
    products' instruction and the most warps resident on an SM, observed
    (``kmeans_kernels.resident_warps``: each warp counts itself live on its
    SM).  Prints, by kernel, the occupancy calculator's launch beside the
    most and the fewest warps an SM observed, over the SMs the launch used,
    and the bound of the float32 FFMA design (ffma_bound)."""
    from heat_tpu_torch.ops import kmeans_kernels as kk

    out = {}
    for name, run, em in (("assign", lambda: kk.fused_assign(x, c), False),
                          ("em_stats", lambda: kk.fused_em_stats(x, c), True)):
        calc = kk.launch_config(K, D, x.dtype, em=em)
        used = kk.resident_warps(run)
        if not used:
            fail(f"{name}: no warp counted itself resident")
        out[name] = {"products": calc["products"], "resident_warps": max(used)}
        print(json.dumps({"phase": "kmeans_launch", "kernel": name, "dtype": str(x.dtype).replace("torch.", ""),
                          "n": x.shape[0], "k": K, "d": D, "occupancy_calculator": calc,
                          "resident_warps_measured": max(used), "resident_warps_measured_min": min(used),
                          "sms_used": len(used), "ffma_bound_ms": ffma_bound(x.shape[0], x.element_size(), em)}),
              flush=True)
    return out


def wide_bwd_f64(q, k, v, do, lse, dd, scale: float, keep=None):
    """The float32 reference of the wide route's dq, dk and dv: the plain
    versions' formulas in float64, cast down to q's, k's and v's dtypes.  P
    = exp(S scale - lse) at the live keys ``keep`` ((Sq, Sk) bool; None:
    all), dS = P (dO V^T - dd) scale, dq = dS K, dk = dS^T Q, dv = P^T dO,
    with K/V rows repeated to q's rows and their gradients summed over each
    group.  Past d = 256 the kernels and the float32 plain versions sum a
    score's d products in different orders, and a row that cancels to
    float32 noise (row 0 of a causal dq: dP - dd = dO.V - dO.O) keeps
    either order's rounding; in float64 the reference holds neither."""
    import torch

    g = q.shape[0] // k.shape[0]
    q64, do64 = q.double(), do.double()
    k64, v64 = (t.double().repeat_interleave(g, dim=0) for t in (k, v))
    s = torch.matmul(q64, k64.transpose(-1, -2)) * scale
    live = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device) if keep is None else keep
    p = torch.where(live, torch.exp(torch.where(live, s, 0.0) - lse.double()[..., None]), 0.0)
    ds = p * (torch.matmul(do64, v64.transpose(-1, -2)) - dd.double()[..., None]) * scale
    dq = torch.matmul(ds, k64)
    dk = torch.matmul(ds.transpose(-1, -2), q64).unflatten(0, (-1, g)).sum(1)
    dv = torch.matmul(p.transpose(-1, -2), do64).unflatten(0, (-1, g)).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def causal_keep(S: int, causal: bool, device):
    """The live keys of an (S, S) block under the static mask; None: all."""
    import torch

    return torch.ones((S, S), dtype=torch.bool, device=device).tril() if causal else None


def pos_keep(qpos, kpos, causal: bool, s_valid: int, masked: bool):
    """The live keys under the positions mask (_masked_scores_pos); None: all."""
    if not masked:
        return None
    keep = (kpos < s_valid)[None, :].expand(qpos.shape[0], -1)
    return keep & (qpos[:, None] >= kpos[None, :]) if causal else keep


def _grad_reference(q, k, v, do, lse, dd, scale: float, keep, plain) -> tuple:
    """(dq, dk, dv to hold the kernels' gradients against, what to print of
    them): the plain versions' ``plain`` but for float32 past WIDE_D, where
    it is wide_bwd_f64's, and the line then names that reference and gives
    the float32 plain versions' own row error against it, by the same
    criterion; {} otherwise."""
    import torch

    if q.shape[-1] <= WIDE_D or q.dtype != torch.float32:
        return plain, {}
    ref = wide_bwd_f64(q, k, v, do, lse, dd, scale, keep)
    return ref, {"grad_reference": "plain formulas in float64",
                 "plain_f32_row_rel_err": dict(zip(("dq", "dk", "dv"), map(_row_err, plain, ref)))}


def _rel_err(got, want) -> float:
    """max |got - want| / max(1, max |want|), in float32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def _row_err(got, want) -> float:
    """max over rows of max |got - want| / max |want| along the last axis, a
    row's scale floored at ROW_FLOOR of the tensor's largest |want| or of 1
    (the inputs' scale), whichever is larger: row 0 of a causal dq cancels
    to ~0 (one key, dS = p(dp - dd) with dd = dp)."""
    got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
    scale = want.abs().amax(-1).clamp_min(ROW_FLOOR * max(float(want.abs().max()), 1.0))
    return float(((got - want).abs().amax(-1) / scale).max())


def _share_above_floor(got, want) -> float:
    """The share of elements that differ at all, among those whose plain
    value reaches the row floor of _row_err (ROW_FLOOR of the tensor's
    largest |want| or of 1): the edge shapes' bfloat16 share.  0 where no
    element reaches it (S = 1: dq and dk are float32 noise of a cancelled
    sum throughout)."""
    got, want = got.float(), want.float()
    big = want.abs() >= ROW_FLOOR * max(float(want.abs().max()), 1.0)
    return float((got != want)[big].float().mean()) if bool(big.any()) else 0.0


def _edge_err(got, want) -> tuple:
    """(row error over the rows whose largest |want| reaches the row floor
    of _row_err, largest |got - want| over the rows below it): the edge
    shapes' float32 criterion for dq, dk and dv, held to FLASH_TOL's grad
    and EDGE_F32_ATOL.  0 for a side with no rows."""
    got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
    floor = ROW_FLOOR * max(float(want.abs().max()), 1.0)
    rowmax, err = want.abs().amax(-1), (got - want).abs().amax(-1)
    big = rowmax >= floor
    above = float((err[big] / rowmax[big]).max()) if bool(big.any()) else 0.0
    below = float(err[~big].max()) if bool((~big).any()) else 0.0
    return above, below


def _edge_ok(err) -> bool:
    """Whether ``err`` = _edge_err(got, want) meets the float32 edge criterion."""
    return err[0] <= FLASH_TOL["float32"]["grad"] and err[1] <= EDGE_F32_ATOL


def _flash_inputs(bhq, bhk, S, d, dtype, seed):
    """q, k, v, dO: q and dO of bhq rows, k and v of bhk."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((rows, S, d), generator=g, device="cuda").to(dtype) for rows in (bhq, bhk, bhk, bhq)]


def _misaligned(t):
    """``t``'s values in a contiguous tensor whose data starts one element
    past the allocator's alignment: the bfloat16 forward then loads element
    by element instead of by 16-byte copies, into the same shared tiles."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape).copy_(t)
    if out.data_ptr() % 16 == 0:
        fail("the misaligned copy is 16-byte aligned")
    return out


def _flash_fns(names):
    """The wrappers of ``names`` and their plain versions (``_torch_<name>``)."""
    from heat_tpu_torch.ops import flash_attention as fa

    return [getattr(fa, n) for n in names], [getattr(fa, f"_torch_{n}") for n in names]


def check_edges(names, edges) -> None:
    """The wrappers ``names`` against their plain versions at the edge
    shapes ``edges``, all three kernels in float32 and bfloat16, with the
    tolerances of ``check_flash_kernels`` but for dq, dk and dv, where whole
    rows cancel to float32 noise (see FWD_EDGE_CHECKS): their bfloat16 share
    counts the elements above the row floor (_share_above_floor; the
    forward's counts every element), and in float32 they are held by
    _edge_err (rows reaching the floor by the row error, rows below it to
    EDGE_F32_ATOL).  Each kernel twice to the same bits, and again to the
    same bits with q (forward) or dO (dq, dk/dv) off 16-byte alignment."""
    import torch

    (fwd, bwd_dq, bwd_dkv), (fwd_p, bwd_dq_p, bwd_dkv_p) = _flash_fns(names)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        tol = FLASH_TOL[dname]
        for bhq, bhk, S, d, causal in edges:
            shape = (bhq, bhk, S, d, causal)
            q, k, v, do = _flash_inputs(bhq, bhk, S, d, dtype, seed=S + d + causal + bhq // bhk - 1)
            scale = d**-0.5
            out, lse = fwd(q, k, v, causal, scale)
            again, lse2 = fwd(q, k, v, causal, scale)
            off, lse3 = fwd(_misaligned(q), k, v, causal, scale)
            out_p, lse_p = fwd_p(q, k, v, causal, scale)
            dd = (do.float() * out.float()).sum(-1)
            grads, repeats, offs = ((bwd_dq(*a, lse, dd, causal, scale),) + tuple(
                bwd_dkv(*a, lse, dd, causal, scale)) for a in ((q, k, v, do), (q, k, v, do),
                                                               (q, k, v, _misaligned(do))))
            plain = (bwd_dq_p(q, k, v, do, lse, dd, causal, scale),) + tuple(
                bwd_dkv_p(q, k, v, do, lse, dd, causal, scale))
            plain, plain_f32 = _grad_reference(q, k, v, do, lse, dd, scale, causal_keep(S, causal, q.device), plain)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(grads, repeats, offs)):
                fail(f"{names[1]} or {names[2]} does not repeat its bits (or not off alignment) at {shape} {dname}")
            if not (torch.equal(out, again) and torch.equal(lse, lse2) and torch.equal(out, off)
                    and torch.equal(lse, lse3)):
                fail(f"{names[0]} does not repeat its bits (or not off alignment) at {shape} {dname}")
            pairs = [("out", out, out_p)] + list(zip(("dq", "dk", "dv"), grads, plain))
            res = {key: _row_err(a, b) for key, a, b in pairs}
            # the forward cannot cancel: its share counts every element, as at every shape
            share = {key: float((a != b).float().mean()) if key == "out" else _share_above_floor(a, b)
                     for key, a, b in pairs}
            lse_err = float((lse - lse_p).abs().max())
            edge = {key: _edge_err(a, b) for key, a, b in pairs[1:]}
            if dtype == torch.bfloat16:
                bad = {key: val for key, val in res.items() if not val <= tol["out" if key == "out" else "grad"]}
                bad.update({f"{key}_differing": val for key, val in share.items()
                            if not val <= bf16_share_limit(d)})
            else:
                bad = {key: val for key, val in edge.items() if not _edge_ok(val)}
                if not res["out"] <= tol["out"]:
                    bad["out"] = res["out"]
            if bad or not lse_err <= LSE_ATOL:
                fail(f"{'+'.join(names)} vs plain at the edge {shape} {dname}: {bad}, {res}, {edge}, {share}, "
                     f"lse {lse_err}")
            print(json.dumps({"phase": "kernel_check", "kernel": "+".join(names), "edge": True, "dtype": dname,
                              "bhq": bhq, "bhk": bhk, "S": S, "d": d, "causal": causal,
                              "max_abs_err": {key: float((a.float() - b.float()).abs().max()) for key, a, b in pairs},
                              "lse_max_abs_err": lse_err, "row_rel_err": res, "row_rel_tol": tol,
                              "edge_err": edge, "edge_f32_atol": EDGE_F32_ATOL,
                              "differing_share": share, "lse_atol": LSE_ATOL, "repeats_bitwise": True,
                              "misaligned_bitwise": True, **plain_f32, "check": "pass"}), flush=True)


def check_flash_kernels(names, checks, main, edges, wide_main=None) -> dict:
    """Each flash kernel, through the wrappers ``names`` (multi-head or
    grouped), against its plain version on the card, and at the tiles'
    edges ``edges``; returns the errors at the main path's shape ``main`` per
    dtype (and at ``wide_main``, head dim 512, under ``d512_<dtype>``) for
    the kernels line."""
    import torch

    from heat_tpu_torch.ops import flash_attention as fa

    (fwd, bwd_dq, bwd_dkv), (fwd_p, bwd_dq_p, bwd_dkv_p) = _flash_fns(names)
    errs = {}
    wide = dict.fromkeys(names, 0)  # each wrapper's launches at the shapes past WIDE_D
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        tol = FLASH_TOL[name]
        for bhq, bhk, S, d, causal in checks:
            shape = (bhq, bhk, S, d, causal)
            before = {n: fa.launch_counts[n] for n in names}
            q, k, v, do = _flash_inputs(bhq, bhk, S, d, dtype, seed=S + d + causal + bhq // bhk - 1)
            scale = d**-0.5
            out, lse = fwd(q, k, v, causal, scale)
            again, lse2 = fwd(q, k, v, causal, scale)
            off, lse3 = fwd(_misaligned(q), k, v, causal, scale)
            torch.cuda.synchronize()
            if not (torch.equal(out, again) and torch.equal(lse, lse2)):
                fail(f"{names[0]} is not deterministic at {shape} {name}")
            if not (torch.equal(out, off) and torch.equal(lse, lse3)):
                fail(f"{names[0]} gives other bits for a q off 16-byte alignment at {shape} {name}")
            dd = (do.float() * out.float()).sum(-1)
            dq = bwd_dq(q, k, v, do, lse, dd, causal, scale)
            dk, dv = bwd_dkv(q, k, v, do, lse, dd, causal, scale)
            dq2 = bwd_dq(q, k, v, do, lse, dd, causal, scale)
            dk2, dv2 = bwd_dkv(q, k, v, do, lse, dd, causal, scale)
            do_off = _misaligned(do)
            dq3 = bwd_dq(q, k, v, do_off, lse, dd, causal, scale)
            dk3, dv3 = bwd_dkv(q, k, v, do_off, lse, dd, causal, scale)
            if d > WIDE_D:
                wide = {n: wide[n] + fa.launch_counts[n] - before[n] for n in names}
            out_p, lse_p = fwd_p(q, k, v, causal, scale)
            dq_p = bwd_dq_p(q, k, v, do, lse, dd, causal, scale)
            dk_p, dv_p = bwd_dkv_p(q, k, v, do, lse, dd, causal, scale)
            (dq_p, dk_p, dv_p), plain_f32 = _grad_reference(q, k, v, do, lse, dd, scale,
                                                            causal_keep(S, causal, q.device), (dq_p, dk_p, dv_p))
            torch.cuda.synchronize()
            if not (torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)):
                fail(f"{names[1]} or {names[2]} is not deterministic at {shape} {name}")
            if not (torch.equal(dq, dq3) and torch.equal(dk, dk3) and torch.equal(dv, dv3)):
                fail(f"{names[1]} or {names[2]} gives other bits for a dO off 16-byte alignment at {shape} {name}")
            res = {"out": _row_err(out, out_p), "dq": _row_err(dq, dq_p), "dk": _row_err(dk, dk_p),
                   "dv": _row_err(dv, dv_p)}
            lse_err = float((lse - lse_p).abs().max())
            share = {key: float((a != b).float().mean())
                     for key, a, b in (("out", out, out_p), ("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p))}
            bad = {key: val for key, val in res.items() if not val <= tol["out" if key == "out" else "grad"]}
            if dtype == torch.bfloat16:
                bad.update({f"{key}_differing": val for key, val in share.items()
                            if not val <= bf16_share_limit(d)})
            if bad or not lse_err <= LSE_ATOL:
                fail(f"flash kernels vs plain at {shape} {name}: {res}, {share}, lse {lse_err}")
            abs_err = {key: float((a.float() - b.float()).abs().max())
                       for key, a, b in (("out", out, out_p), ("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p))}
            print(json.dumps({"phase": "kernel_check", "kernel": "+".join(names), "dtype": name, "bhq": bhq,
                              "bhk": bhk, "S": S, "d": d, "causal": causal, "max_abs_err": abs_err,
                              "lse_max_abs_err": lse_err, "row_rel_err": res, "row_rel_tol": tol,
                              "differing_share": share, "lse_atol": LSE_ATOL, "repeats_bitwise": True,
                              "misaligned_q_bitwise": True, "misaligned_do_bitwise": True, **plain_f32,
                              "check": "pass"}),
                  flush=True)
            if (bhq, bhk, S, d) in (main, wide_main) and causal:
                errs[name if (bhq, bhk, S, d) == main else f"d512_{name}"] = dict(zip(names, ((max(abs_err["out"], lse_err), res["out"]), (abs_err["dq"], res["dq"]),
                                              (max(abs_err["dk"], abs_err["dv"]), max(res["dk"], res["dv"])))))
    check_edges(names, edges)
    check_wide_launched(names, checks, wide)
    return errs


def check_wide_launched(names, checks, launched: dict) -> None:
    """The checks hold each of WIDE_DS; the C dispatch reports every head dim
    of ``checks`` past WIDE_D on the wide route and WIDE_D itself on the
    D = 256 bodies (``flash_attention.route``); and every wrapper of
    ``names`` launched at least once a shape past WIDE_D in both dtypes
    (``launched``: its launch_counts over those shapes)."""
    from heat_tpu_torch.ops import flash_attention as fa

    ds = {c[3] for c in checks if c[3] > WIDE_D}
    if not set(WIDE_DS) <= ds:
        fail(f"{names} checked the wide route at d = {sorted(ds)}, not at every one of {WIDE_DS}")
    routes = {d: fa.route(d) for d in sorted(ds | {WIDE_D})}
    if any(routes[d] != "wide" for d in ds) or routes[WIDE_D] != "d256":
        fail(f"{names}: the C dispatch routes head dims {routes}, want the wide route past {WIDE_D} only")
    if not all(launched[n] >= 2 * sum(c[3] > WIDE_D for c in checks) for n in names):
        fail(f"{names}: launched {launched} times over the shapes past d = {WIDE_D}")
    print(json.dumps({"phase": "kernel_check", "kernel": "+".join(names), "launches_past_wide_d": launched,
                      "routes": {str(d): r for d, r in routes.items()}, "check": "pass"}), flush=True)


def lm_batches(steps: int, seed: int, batch: int = LM_BATCH, seq: int = LM_SEQ):
    """Token batches (steps, batch, seq + 1) int64: each row repeats a random
    segment of LM_SEGMENT tokens from a pool of LM_POOL, so the next token
    is learnable (first its frequency, then by copying)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pool = rng.choice(LM["vocab_size"], LM_POOL, replace=False)
    seg = pool[rng.integers(0, LM_POOL, (steps, batch, LM_SEGMENT))]
    reps = -(-(seq + 1) // LM_SEGMENT)
    return np.tile(seg, (1, 1, reps))[:, :, : seq + 1].astype(np.int64)


def lm_loss(ht, lm, batch):
    logits = lm(batch[:, :-1])
    return ht.nn.functional.cross_entropy(logits.reshape(-1, LM["vocab_size"]), batch[:, 1:].reshape(-1))


def _path_counts(label: str, counts: dict, kernels, want) -> None:
    """The path's kernels launched ``want`` times each (or ``want[kernel]``
    times: under remat the forward runs twice a block, ``flash_step_counts``),
    every other flash kernel never."""
    per = want if isinstance(want, dict) else {key: want for key in kernels}
    expect = {key: per.get(key, 0) if key in kernels else 0 for key in counts}
    if counts != expect:
        fail(f"{label} launches {counts}, want {expect}")


def lm_train(ht, cfg: dict, kernels, label: str, dtype: str = "float32", steps: int = LM_STEPS):
    """A training main path: ``steps`` Adam steps at full width, the weights
    in ``dtype``, counts zeroed just before; each step launches each kernel
    of ``kernels`` once a block and no other flash kernel."""
    import torch

    from heat_tpu_torch.ops import flash_attention as fa

    torch.manual_seed(0)
    lm = ht.nn.models.TransformerLM(**cfg).to(getattr(torch, dtype))
    n_params = sum(p.numel() for p in lm.parameters())
    opt = ht.optim.DataParallelOptimizer("adam", lm.parameters(), lr=LM_LR)
    batches = torch.from_numpy(lm_batches(steps + 1, seed=11)).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in fa.launch_counts:
        fa.launch_counts[key] = 0
    losses, step_s = [], []
    for step in range(steps):
        before = dict(fa.launch_counts)
        t0 = time.perf_counter()
        loss = lm_loss(ht, lm, batches[step])
        opt.zero_grad()
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss.detach()))
        _path_counts(f"{label}, step {step}", {key: fa.launch_counts[key] - before[key] for key in before}, kernels,
                     cfg["depth"])
    counts = dict(fa.launch_counts)
    _path_counts(label, counts, kernels, cfg["depth"] * steps)
    if not all(x == x and abs(x) < float("inf") for x in losses) or not losses[-1] < losses[0]:
        fail(f"{label} loss did not fall: {losses}")
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    print(json.dumps({"phase": "main_path", "path": label, **cfg, "params": n_params,
                      "dtype": dtype, "batch": [LM_BATCH, LM_SEQ + 1], "optimizer": "adam", "lr": LM_LR,
                      "steps": steps, "first_step_ms": step_s[0] * 1e3, "step_ms_median": steady * 1e3,
                      "step_ms": [round(t * 1e3, 3) for t in step_s],
                      "train_tokens_per_s": LM_BATCH * LM_SEQ / steady, "first_loss": losses[0],
                      "last_loss": losses[-1], "losses": [round(x, 4) for x in losses],
                      "peak_mem_bytes": torch.cuda.max_memory_allocated(), "guard_stats": opt.guard_stats(),
                      "launch_counts": counts}), flush=True)
    return lm, opt, counts, batches[steps]


def _kernel_class(name: str) -> str:
    """A CUDA kernel's share of the step, by its name."""
    low = name.lower()
    if "flash_" in low:
        return "flash_attention"
    if any(word in low for word in ("gemm", "gemv", "cutlass", "xmma", "cublas", "sm90_", "nvjet")):
        return "gemm"
    if any(word in low for word in ("softmax", "nll", "cross_entropy")):
        return "softmax_cross_entropy"
    if "multi_tensor" in low or "adam" in low:
        return "optimizer"
    return "other"


def device_events(prof) -> list:
    """The device rows (kernels, memory copies and sets) of a finished
    ``torch.profiler`` session's ``key_averages()``."""
    import torch

    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]


def profiled(fn, label: str, cpu: bool = False, wait_s: float = PROFILE_WAIT_S, complete=None) -> tuple:
    """(a finished ``torch.profiler`` session over one ``fn()``, the wall
    seconds of that call, the card synchronised), with the CPU's activity
    too where ``cpu``.  A process that keeps CUPTI from one session to the
    next can lose every record for good: on an H100, in two runs of
    ``scripts/profiler_probe.py``, 94 of 104 sessions recorded nothing
    once ranks the process spawned on the card had exited, and one run of
    this script lost 42 sessions in a row with no rank spawned.  A session
    can also lose part of its records: two runs saw a BatchParallelKMeans
    fit's ``assign`` kernel, or both its ``assign`` and ``em_stats``
    kernels, launch no time where their wrappers had counted 1 and 4.  So in the
    script's own process (``_TEARDOWN_CUPTI``) each session runs with
    ``TEARDOWN_CUPTI=1``, which makes the profiler finalize CUPTI when the
    session ends (with it, 1 of 52 recorded nothing after a spawn); spawned
    ranks, fresh processes, never inherit it.  A session that still
    records no device activity measured nothing, and so does one for which
    ``complete(prof)`` is false: ``fn()`` runs again at once under a new
    session, for at most ``wait_s`` seconds, and then the run fails.  Every
    ``fn`` here does work on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    deadline, sessions = time.monotonic() + wait_s, 0
    while True:
        torch.cuda.synchronize()
        if _TEARDOWN_CUPTI:
            os.environ["TEARDOWN_CUPTI"] = "1"  # read when the session ends
        try:
            with profile(activities=activities) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            os.environ.pop("TEARDOWN_CUPTI", None)
        sessions += 1
        seen = bool(device_events(prof))
        if seen and (complete is None or complete(prof)):
            return prof, wall
        if time.monotonic() >= deadline:
            what = "recorded fewer launches than the wrappers counted" if seen else "recorded no device activity"
            fail(f"{label}: {sessions} profiler sessions over {wait_s} s {what}")


def profile_device(fn, label: str) -> dict:
    """Device time by kernel class over ``fn()`` (torch.profiler), and the
    device's busy share of the wall time: kernels on one stream do not
    overlap, so their summed time is the busy time.  Prints the row."""
    row = profile_row(fn, label)
    print(json.dumps(row), flush=True)
    return row


def profile_row(fn, label: str, wait_s: float = PROFILE_WAIT_S) -> dict:
    """``profile_device``'s row, unprinted (``wait_s``: ``profiled``'s)."""
    prof, wall = profiled(fn, label, cpu=True, wait_s=wait_s)
    classes, kernels = {}, 0
    for evt in device_events(prof):
        if evt.self_device_time_total <= 0:
            continue
        cls = _kernel_class(evt.key)
        classes[cls] = classes.get(cls, 0.0) + evt.self_device_time_total / 1e3  # us -> ms
        kernels += evt.count
    busy = sum(classes.values())
    if busy <= 0:
        fail(f"{label}: the profiler saw no device time")
    return {"phase": "where_time_goes", "path": label, "wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / (wall * 1e3), "kernel_launches": kernels,
            "device_ms_by_class": {k: round(v, 3) for k, v in sorted(classes.items(), key=lambda kv: -kv[1])}}


def profile_training_step(ht, lm, opt, batch, label: str, dtype: str = "float32") -> dict:
    """One training step under the profiler; prints and returns its row,
    with the flash kernels' share of the device's busy time."""
    def step():
        loss = lm_loss(ht, lm, batch)
        opt.zero_grad()
        loss.backward()
        opt.step()

    row = profile_row(step, f"{label} step ({dtype})")
    row["flash_share_of_busy"] = row["device_ms_by_class"].get("flash_attention", 0.0) / row["device_busy_ms"]
    print(json.dumps(row), flush=True)
    return row


def lm_step_vs_plain(ht, lm, batch, kernels, label: str, tol=(STEP_LOSS_RTOL, STEP_GRAD_RTOL), loss_fn=None,
                     want=None, floor: float = 0.0) -> dict:
    """One step's loss and gradients through the kernels and through their
    plain versions, substituted for the path's three wrappers by mock.patch;
    held to ``tol`` = (loss rtol, gradient rtol), each gradient's largest
    error over its largest entry, that scale floored at ``floor`` of the
    model's largest gradient entry (0: no floor; the encoder-decoder's
    cross-attention LayerNorms get gradients ~1e-6 of the largest, the
    float32 noise of a cancelled sum, as row 0 of a causal dq is).
    ``loss_fn(lm, batch)`` (default the LM's loss) and ``want`` (the
    launches of the kernels' step, default one a block of LM) serve other
    models.  Returns the printed row."""
    from unittest import mock

    from heat_tpu_torch.ops import flash_attention as fa

    loss_fn = loss_fn or (lambda m, b: lm_loss(ht, m, b))

    def step():
        lm.zero_grad(set_to_none=True)
        loss = loss_fn(lm, batch)
        loss.backward()
        return float(loss.detach()), {n: p.grad.detach().clone() for n, p in lm.named_parameters()}

    before = dict(fa.launch_counts)
    loss_k, grads_k = step()
    _path_counts(f"{label}, one step", {key: fa.launch_counts[key] - before[key] for key in before}, kernels,
                 LM["depth"] if want is None else want)
    before = dict(fa.launch_counts)
    patches = [mock.patch.object(fa, name, getattr(fa, f"_torch_{name}")) for name in kernels]
    for patch in patches:
        patch.start()
    try:
        loss_p, grads_p = step()
    finally:
        for patch in patches:
            patch.stop()
    if fa.launch_counts != before:
        fail("the plain step launched a kernel")
    lm.zero_grad(set_to_none=True)
    # each gradient's largest error over its largest entry (floored: ``floor``)
    largest = max(float(g.abs().max()) for g in grads_p.values())
    rel = {n: float((grads_k[n] - grads_p[n]).abs().max()) / max(float(grads_p[n].abs().max()), floor * largest,
                                                                  1e-30) for n in grads_p}
    worst = max(rel.items(), key=lambda t: t[1])
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    row = {"phase": "one_step_vs_plain", "path": label, "dtype": str(next(lm.parameters()).dtype).replace(
        "torch.", ""), "loss": loss_k, "plain_loss": loss_p, "loss_rel_err": loss_rel, "worst_grad": worst[0],
           "worst_grad_rel_err": worst[1], "median_grad_rel_err": sorted(rel.values())[len(rel) // 2],
           "worst_grads": [(n, e, float(grads_p[n].abs().max())) for n, e in sorted(rel.items(),
                                                                                  key=lambda t: -t[1])[:6]],
           "largest_grad": largest, "grad_scale_floor": floor,
           "params_checked": len(grads_p), "loss_rtol": tol[0], "grad_rtol": tol[1]}
    print(json.dumps(row), flush=True)
    if not loss_rel <= tol[0] or not worst[1] <= tol[1]:
        fail(f"one step through the kernels vs plain: loss {loss_rel}, gradient {worst}")
    return row


def lm_d512_step(ht) -> dict:
    """One training step of ``TransformerLM(**LM_D512)``, head dim 512,
    through the kernels against their plain versions (``lm_step_vs_plain``):
    each multi-head wrapper launches once a block, and the C dispatch
    reports head dim 512 on the wide route (``flash_attention.route``)."""
    import torch

    from heat_tpu_torch.ops import flash_attention as fa

    torch.manual_seed(0)
    lm = ht.nn.models.TransformerLM(**LM_D512)
    batch = torch.from_numpy(lm_batches(1, seed=13)[0]).cuda()
    label = "TransformerLM(embed_dim=1024, num_heads=2): head dim 512"
    t0 = time.perf_counter()
    row = lm_step_vs_plain(ht, lm, batch, MHA_KERNELS, label, want=LM_D512["depth"])
    route = fa.route(LM_D512["embed_dim"] // LM_D512["num_heads"])
    if route != "wide":
        fail(f"{label}: the C dispatch routes head dim 512 to {route!r}, want the wide route")
    seconds = time.perf_counter() - t0

    def step():  # forward and backward through the kernels, as the training step runs them
        lm.zero_grad(set_to_none=True)
        lm_loss(ht, lm, batch).backward()

    step_ms = []
    for _ in range(3):  # the first warms up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    print(json.dumps({"phase": "main_path", "path": f"{label}, one step vs plain", **LM_D512, "head_dim": 512,
                      "params": sum(p.numel() for p in lm.parameters()), "batch": [LM_BATCH, LM_SEQ + 1],
                      "seconds": seconds, "step_ms": min(step_ms[1:]), "step_ms_runs": step_ms,
                      "step": "forward and backward, float32, host clock around a synchronized step",
                      "route": route, "check": "pass"}), flush=True)
    del lm, batch
    torch.cuda.empty_cache()
    return row


def lm_generate(ht, lm, fwd_kernel: str, label: str) -> None:
    """Generation in bfloat16 at bench's lm_generate shape; then decoding
    against the bfloat16 forward over the prompt, which launches
    ``fwd_kernel`` once a block."""
    import numpy as np
    import torch

    from heat_tpu_torch.ops import flash_attention as fa

    lm = lm.to(torch.bfloat16).eval()
    kv_heads = lm.blocks[0].mha.num_kv_heads
    prompt = torch.from_numpy(np.random.default_rng(12).integers(0, LM["vocab_size"], (LM_BATCH, PROMPT))).cuda()
    for key in fa.launch_counts:
        fa.launch_counts[key] = 0
    lm.generate(prompt, NEW_TOKENS)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = lm.generate(prompt, NEW_TOKENS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(fa.launch_counts)
    if any(counts.values()):
        fail(f"generation launched flash kernels: {counts}")
    if tuple(out.shape) != (LM_BATCH, PROMPT + NEW_TOKENS) or not torch.equal(out[:, :PROMPT].long(), prompt):
        fail("generate's output is not the prompt followed by the new tokens")
    if int(out.min()) < 0 or int(out.max()) >= LM["vocab_size"]:
        fail("generated tokens out of range")
    print(json.dumps({"phase": "main_path", "path": label, "dtype": "bfloat16", "kv_heads": kv_heads,
                      "prompt": [LM_BATCH, PROMPT], "new_tokens": NEW_TOKENS, "greedy": True, "seconds": dt,
                      "tokens_per_s": LM_BATCH * NEW_TOKENS / dt, "launch_counts": counts}), flush=True)

    with torch.no_grad():
        caches = lm.init_caches(LM_BATCH, PROMPT)
        # the K/V cache a generation of PROMPT + NEW_TOKENS positions holds
        cache_bytes = sum(c[key].numel() * c[key].element_size() for c in caches for key in ("k", "v")) * \
            (PROMPT + NEW_TOKENS) // PROMPT
        if tuple(caches[0]["k"].shape) != (LM_BATCH, kv_heads, PROMPT, LM["embed_dim"] // LM["num_heads"]):
            fail(f"{label}: the cache holds {tuple(caches[0]['k'].shape)}, not {kv_heads} K/V heads")
        dec = torch.stack([lm.decode_step(prompt[:, t], t, caches)[0] for t in range(PROMPT)], dim=1)
        for key in fa.launch_counts:
            fa.launch_counts[key] = 0
        fwd = lm(prompt)
        torch.cuda.synchronize()
    _path_counts(f"{label}: the bfloat16 forward", dict(fa.launch_counts), (fwd_kernel,), LM["depth"])
    rel = _rel_err(dec, fwd)
    agree = float((dec.argmax(-1) == fwd.argmax(-1)).float().mean())
    print(json.dumps({"phase": "decode_vs_forward", "path": label, "dtype": "bfloat16", "positions": PROMPT,
                      "kv_heads": kv_heads, "generation_cache_bytes": cache_bytes,
                      "max_abs_err": float((dec.float() - fwd.float()).abs().max()),
                      "max_abs_logit": float(fwd.float().abs().max()), "rel_err": rel, "rel_tol": DECODE_RTOL,
                      "argmax_agreement": agree, "forward_launches": dict(fa.launch_counts)}), flush=True)
    if not rel <= DECODE_RTOL:
        fail(f"decode vs forward logits differ by {rel} of their largest magnitude")
    profile_device(lambda: lm.generate(prompt[:, :8], 56), f"{label}, 63 decode steps (bfloat16)")


def lm_train_bf16(ht) -> dict:
    """The multi-head LM at LM's width cast to bfloat16: LM_BF16_STEPS Adam
    steps on batches of the float32 phase's shape (each launching every
    multi-head flash kernel once a block, the backward's on the tensor
    cores), a profiled step with the flash share, and one step against the
    plain attention under BF16_STEP_*.  Returns the multi-head launch counts."""
    import torch

    label = "TransformerLM bf16 training"
    lm, opt, counts, batch = lm_train(ht, LM, MHA_KERNELS, label, "bfloat16", LM_BF16_STEPS)
    profile_training_step(ht, lm, opt, batch, label, "bfloat16")
    lm_step_vs_plain(ht, lm, batch, MHA_KERNELS, "TransformerLM (bfloat16)",
                     (BF16_STEP_LOSS_RTOL, BF16_STEP_GRAD_RTOL))
    del lm, opt, batch
    torch.cuda.empty_cache()
    return {key: counts[key] for key in MHA_KERNELS}


def flash_bound(kernel: str, bhq: int, bhk: int, S: int, d: int, itemsize: int):
    """(bound_ms, bound_by) of one causal launch: FLOP at the dtype's peak vs
    bytes moved once.  q, dO, out, dq and the float32 rows have bhq rows;
    k, v, dk and dv bhk (the grouped kernels never repeat K/V)."""
    kernel = kernel.replace("flash_gqa_", "flash_")
    flops = {"flash_fwd": 4, "flash_bwd_dq": 6, "flash_bwd_dkv": 8}[kernel] * bhq * S * S * d / 2
    # (S, d) tensors of q's rows and of K/V's rows read or written, (S,)
    # float32 rows read or written: the forward reads q, k, v and writes out,
    # lse; dq reads q, k, v, dO, lse, dd and writes dq; dk/dv the same and
    # writes dk, dv
    t_q, t_kv, r = {"flash_fwd": (2, 2, 1), "flash_bwd_dq": (3, 2, 2), "flash_bwd_dkv": (2, 4, 2)}[kernel]
    nbytes = (t_q * bhq + t_kv * bhk) * S * d * itemsize + r * bhq * S * 4
    t_ops = flops / (PEAK_F32_FLOPS if itemsize == 4 else PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def device_kernels(fn, top: int = 2, reps: int = 3) -> list:
    """The names of the ``top`` CUDA kernels with the most device time over
    ``reps`` calls of ``fn()``: which backend a library call took."""
    prof, _ = profiled(lambda: [fn() for _ in range(reps)], "device_kernels")
    evts = [e for e in device_events(prof) if e.self_device_time_total > 0]
    return [e.key[:120] for e in sorted(evts, key=lambda e: -e.self_device_time_total)[:top]]


def sdpa_backend(kernels) -> str:
    """Which backend of ``scaled_dot_product_attention`` served a call, read
    from the names of its kernels (``device_kernels``): cuDNN's, the flash
    kernels, the memory-efficient (CUTLASS fmha) kernels, or the math path's
    products and softmax."""
    low = " ".join(kernels).lower()
    if "cudnn" in low:
        return "cudnn"
    if "fmha" in low or "memeff" in low:
        return "efficient"
    return "flash" if "flash" in low else "math"


def time_flash(names, bhq, bhk, S, d, dtype, reps: int) -> dict:
    """ms of each kernel, its plain version and the library call, causal, at
    q (bhq, S, d) and k, v (bhk, S, d), through the wrappers ``names``."""
    import torch

    sdpa = torch.nn.functional.scaled_dot_product_attention
    (fwd, bwd_dq, bwd_dkv), (fwd_p, bwd_dq_p, bwd_dkv_p) = _flash_fns(names)
    q, k, v, do = _flash_inputs(bhq, bhk, S, d, dtype, seed=5)
    scale = d**-0.5
    out, lse = fwd(q, k, v, True, scale)
    dd = (do.float() * out.float()).sum(-1)
    # the library call on (B, H, S, d) views: given (B*H, S, d) it takes its math path
    hq = LM["num_heads"]
    q4, do4 = (t.view(-1, hq, S, d) for t in (q, do))
    k4, v4 = (t.view(-1, hq * bhk // bhq, S, d) for t in (k, v))
    gqa = {"enable_gqa": True} if bhk != bhq else {}
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q4, k4, v4))
    lib_out = sdpa(qg, kg, vg, is_causal=True, **gqa)

    def lib_fwd():
        return sdpa(q4, k4, v4, is_causal=True, **gqa)

    def lib_bwd():
        return torch.autograd.grad(lib_out, (qg, kg, vg), do4, retain_graph=True)

    lib_bwd_ms, lib_bwd_kernels = cuda_ms(lib_bwd, reps), device_kernels(lib_bwd)
    res = {
        names[0]: (cuda_ms(lambda: fwd(q, k, v, True, scale), reps), cuda_ms(lambda: fwd_p(q, k, v, True, scale), 3),
                   cuda_ms(lib_fwd, reps), device_kernels(lib_fwd)),
        names[1]: (cuda_ms(lambda: bwd_dq(q, k, v, do, lse, dd, True, scale), reps),
                   cuda_ms(lambda: bwd_dq_p(q, k, v, do, lse, dd, True, scale), 3), lib_bwd_ms, lib_bwd_kernels),
        names[2]: (cuda_ms(lambda: bwd_dkv(q, k, v, do, lse, dd, True, scale), reps),
                   cuda_ms(lambda: bwd_dkv_p(q, k, v, do, lse, dd, True, scale), 3), lib_bwd_ms, lib_bwd_kernels),
    }
    rows = {}
    for name, (ms, plain_ms, lib_ms, lib_kernels) in res.items():
        b_ms, b_by = flash_bound(name, bhq, bhk, S, d, q.element_size())
        rows[name] = {"shape": [bhq, bhk, S, d], "causal": True, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": lib_ms, "library_kernels": lib_kernels,
                      "library_backend": sdpa_backend(lib_kernels)}
    return rows


def flash_cores(name: str) -> dict:
    """What a flash wrapper's kernel multiplies on, by dtype: every bfloat16
    launch runs an mma.sync body (flash_fwd_tc.cuh, flash_bwd_tc.cuh), every
    float32 launch a CUDA-core body (flash_f32.cuh)."""
    return {"float32": "CUDA cores", "bfloat16": "mma.sync tensor cores"}


def flash_sources(name: str) -> dict:
    return {"float32": F32_SOURCE, "bfloat16": FWD_TC_SOURCE if name.endswith("_fwd") else BWD_TC_SOURCE}


def flash_bodies(name: str) -> dict:
    """The CUDA kernel template that each dtype's launch of a flash wrapper runs."""
    kind = "fwd" if name.endswith("_fwd") else "bwd_dq" if name.endswith("_dq") else "bwd_dkv"
    return {"float32": f"flash_{kind}_f32_kernel", "bfloat16": f"flash_{kind}_bf16_kernel"}


def _ptxas_rows(log: str, args_of) -> list:
    """ptxas's registers and spills for each compiled kernel whose mangled
    name ``args_of`` maps to a dict (its template arguments), not None."""
    import re

    rows, cur = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            cur = args_of(entry.group(1))
            continue
        if cur is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            cur.update(spill_stores=int(spill.group(1)), spill_loads=int(spill.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            rows.append({**cur, "registers": int(regs.group(1))})
            cur = None
    return rows


def ptxas_report(log: str, word: str) -> list:
    """ptxas's registers and spills for each compiled instance of the
    flash kernel template ``word`` (its template arguments read from the
    mangled name: D, 16-byte loads, mask)."""
    import re

    def args_of(name):
        args = re.search(word + r"ILi(\d+)ELb([01])ENS_\d+(\w+?)EE", name)
        return {"D": int(args.group(1)), "vec": args.group(2) == "1", "mask": args.group(3)} if args else None

    return _ptxas_rows(log, args_of)


def wide_ptxas_report(log: str, word: str) -> list:
    """ptxas's registers and spills for each compiled instance of the wide
    route's kernel ``word``: its storage type, 16-byte loads (the backward's)
    and mask, read from the mangled name."""
    import re

    def args_of(name):
        args = re.search(r"\d" + word + r"I(f|13__nv_bfloat16)(?:Lb([01])E)?NS_\d+(\w+?)EE", name)
        if not args:
            return None
        row = {"dtype": "float32" if args.group(1) == "f" else "bfloat16", "mask": args.group(3)}
        return row if args.group(2) is None else {**row, "vec": args.group(2) == "1"}

    return _ptxas_rows(log, args_of)


def kmeans_ptxas_report(log: str, word: str) -> list:
    """ptxas's registers and spills for each compiled instance of the KMeans
    kernel ``word``: its template arguments (storage type, DP columns, the
    products' instruction: wgmma or mma.sync) read from the mangled name,
    none for a kernel that is not a template (em_reduce_kernel)."""
    import re

    def args_of(name):
        args = re.search(r"\d" + word + r"I(f|13__nv_bfloat16)Li(\d+)ELb([01])EE", name)
        if args:
            return {"dtype": "float32" if args.group(1) == "f" else "bfloat16", "DP": int(args.group(2)),
                    "products": "wgmma" if args.group(3) == "1" else "mma.sync"}
        return {} if re.search(r"\d" + word + "E", name) else None

    return _ptxas_rows(log, args_of)


def flash_rows(names, main, replaces, launches: dict, errs: dict, bench=None, launches_bf16=None,
               wide=None, d512=None) -> list:
    """The kernels line's rows of the wrappers ``names``: float32 at the
    training step's shape ``main``, with bfloat16 at that shape (and its
    launches in the bfloat16 training phase, ``launches_bf16``) and, given
    ``bench`` and ``wide``, at the attention benchmark's shape and at head
    dim 256 (``d256_<dtype>``), and given ``d512`` at head dim 512, the wide
    route (``d512_<dtype>``, with its errors there), in both dtypes."""
    import torch

    f32 = time_flash(names, *main, torch.float32, 20)
    bf16 = time_flash(names, *main, torch.bfloat16, 20)
    at_bench = {dt: time_flash(names, *bench, getattr(torch, dt), 5) for dt in ("float32", "bfloat16")
                if bench}
    at_wide = {dt: time_flash(names, *wide, getattr(torch, dt), 5) for dt in ("float32", "bfloat16") if wide}
    at_d512 = {dt: time_flash(names, *d512, getattr(torch, dt), 3) for dt in ("float32", "bfloat16") if d512}
    gqa = ", enable_gqa=True" if main[0] != main[1] else ""
    lib = [f"scaled_dot_product_attention(is_causal=True{gqa}) forward"] + \
        [f"scaled_dot_product_attention(is_causal=True{gqa}) backward: dq, dk and dv together"] * 2
    rows = []
    for name, line, lib_call in zip(names, replaces, lib):
        rows.append({
            "name": name, "route": "cuda", "source": flash_sources(name)["float32"], "cores": flash_cores(name),
            "sources": flash_sources(name), "bodies": flash_bodies(name),
            "replaces": f"heat_tpu/ops/flash_attention.py:{line}", "launches": launches[name],
            "launches_per_step": launches[name] // LM_STEPS, "max_abs_err": errs["float32"][name][0],
            "row_rel_err": errs["float32"][name][1],
            **f32[name], "library_call": lib_call,
            "bfloat16": {**bf16[name], "max_abs_err": errs["bfloat16"][name][0],
                         "row_rel_err": errs["bfloat16"][name][1],
                         **({"launches": launches_bf16[name]} if launches_bf16 else {})},
            **{f"bench_shape_{dt}": timed[name] for dt, timed in at_bench.items()},
            **{f"d256_{dt}": timed[name] for dt, timed in at_wide.items()},
            **{f"d512_{dt}": {**timed[name], **wide_route(name, d512[3], dt), "max_abs_err": errs[f"d512_{dt}"][name][0],
                              "row_rel_err": errs[f"d512_{dt}"][name][1]} for dt, timed in at_d512.items()},
            "check": "pass",
        })
    return rows


def wide_route(name: str, d: int, dtype: str) -> dict:
    """The wide route's source for a wrapper's kernel at head dim ``d`` and
    how its launcher splits d (``flash_attention.wide_plan``): blocks a
    cluster, columns a block, passes, shared bytes a block, and the products
    at full d that the plan gives a live tile pair (from the split, not
    counted by the kernels)."""
    import torch

    from heat_tpu_torch.ops import flash_attention as fa

    kernel = "fwd" if name.endswith("_fwd") else "dq" if name.endswith("_dq") else "dkv"
    source = WIDE_SOURCE if kernel == "fwd" else WIDE_BWD_SOURCE
    return {"route": f"wide ({source.rsplit('/', 1)[1]})", **fa.wide_plan(d, getattr(torch, dtype), kernel)}


def _pos_inputs(B, Sq, Sk, d, qo, ko, dtype, seed):
    """q, k, v, dO, an lse cotangent, and int32 positions on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn((B, Sq, d), generator=g, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn((B, Sk, d), generator=g, device="cuda").to(dtype) for _ in range(2))
    g_lse = torch.randn((B, Sq), generator=g, device="cuda")
    qpos = torch.arange(qo, qo + Sq, dtype=torch.int32, device="cuda")
    kpos = torch.arange(ko, ko + Sk, dtype=torch.int32, device="cuda")
    return q, k, v, do, g_lse, qpos, kpos


def check_pos_kernels() -> dict:
    """The positions kernels against their plain versions on the card;
    returns the errors at the ring step's blocks per dtype and block."""
    import torch

    from heat_tpu_torch.ops import flash_attention as fa

    errs = {}
    wide = dict.fromkeys(POS_KERNELS, 0)  # each wrapper's launches at the shapes past WIDE_D
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        tol = FLASH_TOL[name]
        for B, Sq, Sk, d, qo, ko, causal, s_valid in POS_CHECKS:
            shape = (B, Sq, Sk, d, qo, ko, causal, s_valid)
            before = {n: fa.launch_counts[n] for n in POS_KERNELS}
            q, k, v, do, g_lse, qpos, kpos = _pos_inputs(B, Sq, Sk, d, qo, ko, dtype, seed=Sq + Sk + d + qo)
            args = (qpos, kpos, causal, d**-0.5, s_valid, causal or s_valid < 2**30)
            out, lse = fa.flash_pos_fwd(q, k, v, *args)
            again, lse2 = fa.flash_pos_fwd(q, k, v, *args)
            off, lse3 = fa.flash_pos_fwd(q, _misaligned(k), v, *args)
            dd = (do.float() * out.float()).sum(-1) - g_lse  # the lse cotangent folds into dd
            dq = fa.flash_pos_bwd_dq(q, k, v, do, lse, dd, *args)
            dk, dv = fa.flash_pos_bwd_dkv(q, k, v, do, lse, dd, *args)
            dq2 = fa.flash_pos_bwd_dq(q, k, v, do, lse, dd, *args)
            dk2, dv2 = fa.flash_pos_bwd_dkv(q, k, v, do, lse, dd, *args)
            k_off = _misaligned(k)
            dq3 = fa.flash_pos_bwd_dq(q, k_off, v, do, lse, dd, *args)
            dk3, dv3 = fa.flash_pos_bwd_dkv(q, k_off, v, do, lse, dd, *args)
            if d > WIDE_D:
                wide = {n: wide[n] + fa.launch_counts[n] - before[n] for n in POS_KERNELS}
            torch.cuda.synchronize()
            if not (torch.equal(out, again) and torch.equal(lse, lse2) and torch.equal(dq, dq2)
                    and torch.equal(dk, dk2) and torch.equal(dv, dv2)):
                fail(f"the positions kernels do not repeat bit for bit at {shape} {name}")
            if not (torch.equal(out, off) and torch.equal(lse, lse3) and torch.equal(dq, dq3)
                    and torch.equal(dk, dk3) and torch.equal(dv, dv3)):
                fail(f"the positions kernels give other bits for a k off 16-byte alignment at {shape} {name}")
            out_p, lse_p = fa._torch_flash_pos_fwd(q, k, v, *args)
            (dq_p, dk_p, dv_p), plain_f32 = _grad_reference(
                q, k, v, do, lse, dd, d**-0.5, pos_keep(qpos, kpos, causal, s_valid, args[-1]),
                (fa._torch_flash_pos_bwd_dq(q, k, v, do, lse, dd, *args),
                 *fa._torch_flash_pos_bwd_dkv(q, k, v, do, lse, dd, *args)))
            pairs = (("out", out, out_p), ("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p))
            res = {key: _row_err(a, b) for key, a, b in pairs}
            share = {key: float((a != b).float().mean()) for key, a, b in pairs}
            abs_err = {key: float((a.float() - b.float()).abs().max()) for key, a, b in pairs}
            lse_err = float((lse - lse_p).abs().max())
            bad = {key: val for key, val in res.items() if not val <= tol["out" if key == "out" else "grad"]}
            if dtype == torch.bfloat16:
                bad.update({f"{key}_differing": val for key, val in share.items()
                            if not val <= bf16_share_limit(d)})
            if qo + Sq <= ko and causal and (out.any() or dq.any() or dk.any() or dv.any()
                                             or not bool((lse == -1e30).all())):
                bad["dead_block"] = "a block after every query gave out, dq, dk or dv != 0 or lse != -1e30"
            if bad or not lse_err <= LSE_ATOL:
                fail(f"positions kernels vs plain at {shape} {name}: {bad}, {res}, lse {lse_err}")
            block = next((b for b, offs in POS_BLOCKS.items() if (B, Sq, Sk, d) == POS_MAIN and offs == (qo, ko)),
                         None)
            print(json.dumps({"phase": "kernel_check", "kernel": "+".join(POS_KERNELS), "dtype": name,
                              "shape": {"B": B, "Sq": Sq, "Sk": Sk, "d": d, "q_offset": qo, "k_offset": ko,
                                        "causal": causal, "s_valid": s_valid}, "ring_block": block,
                              "max_abs_err": abs_err, "lse_max_abs_err": lse_err, "row_rel_err": res,
                              "row_rel_tol": tol, "differing_share": share, "lse_atol": LSE_ATOL,
                              "repeats_bitwise": True, "misaligned_k_bitwise": True, **plain_f32,
                              "check": "pass"}), flush=True)
            if d == 512:  # the wide route's errors at the d512 timings' head dim
                errs.setdefault(f"d512_{name}", {})[str(shape)] = {
                    "flash_pos_fwd": max(abs_err["out"], lse_err), "flash_pos_bwd_dq": abs_err["dq"],
                    "flash_pos_bwd_dkv": max(abs_err["dk"], abs_err["dv"])}
            if block:
                errs.setdefault(name, {})[block] = {
                    "flash_pos_fwd": max(abs_err["out"], lse_err), "flash_pos_bwd_dq": abs_err["dq"],
                    "flash_pos_bwd_dkv": max(abs_err["dk"], abs_err["dv"])}
    check_wide_launched(POS_KERNELS, POS_CHECKS, wide)
    return errs


def _ring_step(ht, lm, comm, batch, lo: int, hi: int, params=None):
    """One sequence-parallel step's forward and backward on this rank's
    positions [lo, hi) of ``batch`` (B, S + 1): the loss is the global mean
    (the local sum, Allreduced, over the global token count) and the
    gradients are summed over the ranks by the bucketed sync (of
    ``params``, default every parameter: an MoE's expert shards are whole
    on their rank and are left out).  Returns the loss."""
    inp, tgt = batch[:, :-1][:, lo:hi], batch[:, 1:][:, lo:hi]
    logits = lm(inp)
    local = ht.nn.functional.cross_entropy(logits.reshape(-1, LM["vocab_size"]), tgt.reshape(-1), reduction="sum")
    count = batch.shape[0] * (batch.shape[1] - 1)
    lm.zero_grad(set_to_none=True)
    (local / count).backward()
    ht.core.collectives.bucketed_grad_allreduce(comm, [p.grad for p in (lm.parameters() if params is None else params)], op="sum")
    return float(comm.Allreduce(local.detach().clone())) / count


def ring_rank(rank: int, port: int, out_q) -> None:
    """One rank of the sequence-parallel main path (a spawned process):
    training, the step against world size 1 (rank 0), a profiled step.
    Puts (rank, result) on ``out_q``; any failure raises, so the process
    exits non-zero."""
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ht.core.bootstrap.init_distributed(f"tcp://localhost:{port}", world_size=RING_RANKS, rank=rank, backend="gloo",
                                       timeout_s=RING_TIMEOUT_S)
    try:
        ht.use_device("gpu")
        comm = ht.core.communication.get_comm()
        lo, _, _ = comm.chunk((RING_SEQ,), 0)
        hi = lo + comm.chunk((RING_SEQ,), 0)[1][0]
        torch.manual_seed(0)
        lm = ht.nn.models.TransformerLM(**LM_RING, comm=comm)
        for p in lm.parameters():  # every rank holds rank 0's weights
            comm.Bcast(p.data)
        opt = ht.optim.DataParallelOptimizer("adam", lm.parameters(), lr=LM_LR)
        batches = torch.from_numpy(lm_batches(LM_STEPS + 2, 13, RING_BATCH, RING_SEQ)).cuda()
        res = {"rank": rank, "positions": [lo, hi], "transport": comm.transport(batches),
               "device": str(batches.device)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for key in fa.launch_counts:
            fa.launch_counts[key] = 0
        losses, step_s = [], []
        for step in range(LM_STEPS):
            t0 = time.perf_counter()
            losses.append(_ring_step(ht, lm, comm, batches[step], lo, hi))
            opt.step()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        res.update(launch_counts=dict(fa.launch_counts), losses=losses, step_s=step_s,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(), guard_stats=opt.guard_stats())

        # one ring step against one world-1 step of the same weights (rank 0)
        batch = batches[LM_STEPS]
        loss_r = _ring_step(ht, lm, comm, batch, lo, hi)
        if rank == 0:
            grads_r = {n: p.grad.detach().clone() for n, p in lm.named_parameters()}
            one = ht.nn.models.TransformerLM(**LM_RING)
            one.load_state_dict(lm.state_dict())
            before = dict(fa.launch_counts)
            loss_1 = lm_loss(ht, one, batch)
            loss_1.backward()
            res["world_one_launches"] = {k: fa.launch_counts[k] - before[k] for k in before}
            worst = max(((n, float((grads_r[n] - p.grad).abs().max()) / max(float(p.grad.abs().max()), 1e-30))
                         for n, p in one.named_parameters()), key=lambda t: t[1])
            res.update(step_loss=loss_r, world_one_loss=float(loss_1.detach()), worst_grad=worst,
                       params_checked=len(grads_r))
            del one, grads_r
        comm_row = None
        if rank == 0:
            # one session only: a session taken again would run a ring step rank 1 does not join
            comm_row = profile_row(lambda: _ring_step(ht, lm, comm, batches[LM_STEPS + 1], lo, hi),
                                   "TransformerLM(comm=2 ranks) training step, rank 0", wait_s=0.0)
        else:
            _ring_step(ht, lm, comm, batches[LM_STEPS + 1], lo, hi)
        torch.cuda.synchronize()
        res["profile"] = comm_row
        del lm, opt, batches, batch
        torch.cuda.empty_cache()
        # phase 11b's two-rank part: the MoE LM, Pipelined and the decoder against world size 1
        res["nn"] = nn_two_rank_cases(ht, comm, rank)
        torch.distributed.barrier()
        out_q.put((rank, res))
    finally:
        ht.core.bootstrap.finalize_distributed()


def spawn_ranks(target, world: int, timeout_s: float, *args) -> dict:
    """Run ``target(rank, port, out_q, *args)`` in ``world`` spawned
    processes that meet at a free localhost port; returns {rank: result}
    from what each puts on ``out_q``.  A rank that exits non-zero, or does
    not report within ``timeout_s``, fails the run; every process is gone
    on return."""
    import torch

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = torch.multiprocessing.get_context("spawn")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, port, out_q, *args)) for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(results) < world:
            try:
                rank, res = out_q.get(timeout=5)
                results[rank] = res
            except queue.Empty:
                failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if failed:
                    fail(f"a rank exited with {failed} before reporting")
                if time.monotonic() > deadline:
                    fail(f"the ranks did not report within {timeout_s} s")
        for p in procs:
            p.join(120)
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            fail(f"ranks exited with {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return results


# the parts of phases 3b-3g that run on 2 ranks, in the order ``two_rank_world`` runs them
TWO_RANK_PARTS = ("indexing", "matmul", "linalg", "data_parallel", "statistics", "estimators", "surface")
TWO_RANK_TIMEOUT_S = 900  # the whole world's; each part took 15-110 s on an H100


def two_rank_world(rank: int, port: int, out_q, args: dict, parts=TWO_RANK_PARTS) -> None:
    """One of 2 ranks on this card over gloo that runs the ``parts`` (of
    TWO_RANK_PARTS, in that order) in one world, so the ranks come up once:
    each part after a barrier, with the settings a fresh process has (IEEE
    float32 products, cuDNN's own choice of algorithm), the card's cache
    emptied after it.  ``args`` holds a part's extra arguments by name.
    Puts (rank, {part: its result, "_seconds": {part: its seconds}}) on
    ``out_q``."""
    import torch

    import heat_tpu_torch as ht

    bodies = {"indexing": index_rank, "matmul": matmul_rank, "linalg": linalg_rank, "data_parallel": dp_rank,
              "statistics": stats_rank, "estimators": estimators_rank, "surface": surface_rank}
    ht.core.bootstrap.init_distributed(f"tcp://localhost:{port}", world_size=2, rank=rank, backend="gloo",
                                       timeout_s=RING_TIMEOUT_S)
    try:
        ht.use_device("gpu")
        res, seconds = {}, {}
        for name in parts:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
            torch.backends.cudnn.deterministic = False
            torch.distributed.barrier()
            t0 = time.perf_counter()
            res[name] = bodies[name](ht, rank, *args.get(name, ()))
            torch.cuda.synchronize()
            torch.distributed.barrier()
            seconds[name] = time.perf_counter() - t0
            torch.cuda.empty_cache()
        res["_seconds"] = seconds
        out_q.put((rank, res))
    finally:
        ht.core.bootstrap.finalize_distributed()


def two_rank_phases(ht, smi: str, parts=TWO_RANK_PARTS) -> dict:
    """Phases 3b-3g's two-rank parts (``parts``, by default all): one world
    of 2 spawned ranks on this card (``two_rank_world``), then each part's
    checks against world size 1 here, in the world's order; prints the
    world's seconds and returns the seconds of the linear algebra, data
    parallel and surface parts, where they ran."""
    t0 = time.perf_counter()
    out = {}
    with scratch_dir() as d:
        r2 = os.path.join(d, "r2")
        os.makedirs(r2)
        results = spawn_ranks(two_rank_world, 2, TWO_RANK_TIMEOUT_S,
                              {"statistics": (STATS_2R_SORT,), "surface": (r2,)}, parts)
        world_s = time.perf_counter() - t0
        seconds = results[0]["_seconds"]
        checks = {"indexing": lambda r: indexing_two_ranks(ht, smi, r, seconds["indexing"]),
                  "matmul": lambda r: matmul_two_ranks(smi, r),
                  "linalg": lambda r: linalg_two_ranks(ht, smi, r),
                  "data_parallel": lambda r: data_parallel_two_ranks(smi, r),
                  "statistics": lambda r: stats_two_ranks(ht, smi, r, seconds["statistics"]),
                  "estimators": lambda r: estimators_two_ranks(ht, smi, r, seconds["estimators"]),
                  "surface": lambda r: surface_two_ranks(ht, smi, r, seconds["surface"], r2)}
        for name in parts:
            t1 = time.perf_counter()
            ret = checks[name]({rank: res[name] for rank, res in results.items()})
            out[name] = ret if name == "surface" else seconds[name] + time.perf_counter() - t1
    print(json.dumps({"phase": "two_rank_world", "note": "one world of 2 processes on ONE card over gloo for 3b-3g",
                      "spawns": 1, "parts": list(parts), "world_seconds": world_s, "part_seconds_rank0": seconds,
                      "checks_seconds": time.perf_counter() - t0 - world_s, "card": smi}), flush=True)
    return out


def ring_train(smi: str) -> dict:
    """The sequence-parallel main path: RING_RANKS spawned processes on this
    card; checks what they report (phase 11b's two-rank part too) and
    returns rank 0's result with both ranks' launch counts."""
    results = spawn_ranks(ring_rank, RING_RANKS, RING_TIMEOUT_S)
    want = LM_RING["depth"] * LM_STEPS * RING_RANKS
    for rank, res in sorted(results.items()):
        _path_counts(f"TransformerLM(comm) training, rank {rank}", res["launch_counts"], POS_KERNELS, want)
        losses = res["losses"]
        if not all(x == x and abs(x) < float("inf") for x in losses) or not losses[-1] < losses[0]:
            fail(f"rank {rank}: the ring loss did not fall: {losses}")
    if results[0]["losses"] != results[1]["losses"]:
        fail("the ranks report different global losses")
    r0 = results[0]
    steady = sorted(r0["step_s"][1:])[len(r0["step_s"][1:]) // 2]
    print(json.dumps({
        "phase": "main_path", "path": "TransformerLM(comm) sequence-parallel training", **LM_RING,
        "ranks": RING_RANKS, "ranks_share_one_card": True, "transport": r0["transport"], "dtype": "float32",
        "batch": [RING_BATCH, RING_SEQ + 1], "positions_per_rank": [res["positions"] for _, res in sorted(
            results.items())], "optimizer": "adam", "lr": LM_LR, "steps": LM_STEPS,
        "first_step_ms": r0["step_s"][0] * 1e3, "step_ms_median": steady * 1e3,
        "step_ms": [round(t * 1e3, 3) for t in r0["step_s"]], "train_tokens_per_s": RING_BATCH * RING_SEQ / steady,
        "first_loss": r0["losses"][0], "last_loss": r0["losses"][-1], "losses": [round(x, 4) for x in r0["losses"]],
        "peak_mem_bytes_per_rank": [res["peak_mem_bytes"] for _, res in sorted(results.items())],
        "guard_stats": r0["guard_stats"],
        "launch_counts_per_rank": [res["launch_counts"] for _, res in sorted(results.items())]}), flush=True)
    loss_rel = abs(r0["step_loss"] - r0["world_one_loss"]) / abs(r0["world_one_loss"])
    print(json.dumps({"phase": "ring_step_vs_world_one", "loss": r0["step_loss"], "world_one_loss":
                      r0["world_one_loss"], "loss_rel_err": loss_rel, "worst_grad": r0["worst_grad"][0],
                      "worst_grad_rel_err": r0["worst_grad"][1], "params_checked": r0["params_checked"],
                      "world_one_launches": r0["world_one_launches"], "loss_rtol": STEP_LOSS_RTOL,
                      "grad_rtol": STEP_GRAD_RTOL}), flush=True)
    if not loss_rel <= STEP_LOSS_RTOL or not r0["worst_grad"][1] <= STEP_GRAD_RTOL:
        fail(f"the ring step vs world size 1: loss {loss_rel}, gradient {r0['worst_grad']}")
    _path_counts("the world-1 step", r0["world_one_launches"], MHA_KERNELS, LM_RING["depth"])
    print(json.dumps(r0["profile"]), flush=True)
    nn_two_ranks_check(results, smi)
    return {key: r0["launch_counts"][key] for key in POS_KERNELS}


# ---------------------------------------------------------------------- #
# phase 11b: the rest of the nn surface (slice 17)
# ---------------------------------------------------------------------- #
def flash_step_counts(enc: int, dec: int = 0, equal_cross: bool = True, remat: bool = False) -> dict:
    """The multi-head flash launches of one training step of a model with
    ``enc`` self-attention blocks (an LM's or an encoder's) and ``dec``
    decoder blocks (a causal self-attention and a cross-attention each; the
    cross-attention takes the flash kernels where the memory is as long as
    the target, the dense path otherwise).  Under ``remat`` every block's
    forward runs again in the backward."""
    attn = enc + dec + (dec if equal_cross else 0)
    return {"flash_fwd": attn * (2 if remat else 1), "flash_bwd_dq": attn, "flash_bwd_dkv": attn}


def drop_share(stats) -> float:
    """The share of an MoE model's claims dropped at capacity: ``stats``,
    each block's (dropped, valid claims) of one forward."""
    dropped = sum(int(s[0]) for s in stats)
    claims = sum(int(s[1]) for s in stats)
    return dropped / claims if claims else 0.0


def greedy_agreement(tokens, logits, rtol: float = GREEDY_TIE_RTOL) -> dict:
    """Greedy tokens (B, n) against the teacher-forced logits (B, n, V) over
    their prefix: the positions whose token is not the argmax, and of those
    the ones that are not near ties (the token's logit more than ``rtol`` of
    the largest |logit| below the argmax's)."""
    import torch

    logits = logits.float()
    mine = logits.gather(-1, tokens.long()[..., None])[..., 0]
    gap = logits.max(-1).values - mine
    apart = logits.argmax(-1) != tokens.long()
    far = apart & (gap > rtol * float(logits.abs().max()))
    return {"positions": int(tokens.numel()), "not_argmax": int(apart.sum()), "not_near_tie": int(far.sum()),
            "largest_gap": float(torch.where(apart, gap, torch.zeros_like(gap)).max())}


def s2s_batches(steps: int, seed: int, batch: int = S2S_BATCH, seq: int = S2S_SEQ):
    """Source ids (steps, batch, seq) int64 from a pool of LM_POOL tokens
    (id 0, the BOS, left out); the target is the source (a copy task)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pool = rng.choice(S2S_BASE["src_vocab"] - 1, LM_POOL, replace=False) + 1
    return pool[rng.integers(0, LM_POOL, (steps, batch, seq))].astype(np.int64)


def s2s_loss(ht, m, src):
    """The copy task's teacher-forced loss: the decoder reads BOS and the
    source shifted by one, and predicts the source."""
    import torch

    dec_in = torch.nn.functional.pad(src[:, :-1], (1, 0), value=0)
    logits = m(src, dec_in)
    return ht.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]), src.reshape(-1))


def _synced_s(fn) -> tuple:
    """(fn(), its wall seconds with the card synchronised)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _train(ht, m, opt, batches, loss_fn, want: dict, label: str, aux=None, stats=None) -> dict:
    """Adam steps of ``m`` over ``batches`` with the flash launches of each
    step held to ``want``; ``aux()`` adds to the loss, ``stats()`` gives an
    MoE's dropped-claims share of the step.  Returns the step records."""
    import torch

    from heat_tpu_torch.ops import flash_attention as fa

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, drops = [], [], []
    for step, batch in enumerate(batches):
        before = dict(fa.launch_counts)
        t0 = time.perf_counter()
        loss = loss_fn(m, batch)
        total = loss + aux() if aux is not None else loss
        opt.zero_grad()
        total.backward()
        opt.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss.detach()))
        if stats is not None:
            drops.append(stats())
        _path_counts(f"{label}, step {step}", {k: fa.launch_counts[k] - before[k] for k in before}, MHA_KERNELS,
                     want)
    if not all(x == x and abs(x) < float("inf") for x in losses) or not losses[-1] < losses[0]:
        fail(f"{label}: the loss did not fall: {losses}")
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    return {"losses": [round(x, 4) for x in losses], "first_step_ms": step_s[0] * 1e3,
            "step_ms_median": steady * 1e3, "step_ms": [round(t * 1e3, 3) for t in step_s],
            "peak_mem_bytes": torch.cuda.max_memory_allocated(), "drop_share": drops, "steady_s": steady}


def seq2seq_base(ht, smi: str) -> None:
    """Phase 11b's Seq2SeqTransformer at transformer-base width: training,
    one step against the plain attention, a shorter target through the
    dense cross path, greedy and beam decoding."""
    from unittest import mock

    import torch

    from heat_tpu_torch.ops import flash_attention as fa

    V = S2S_BASE["tgt_vocab"]
    torch.manual_seed(0)
    m = ht.nn.models.Seq2SeqTransformer(**S2S_BASE)
    n_params = sum(p.numel() for p in m.parameters())
    opt = ht.optim.DataParallelOptimizer("adam", m.parameters(), lr=LM_LR)
    data = torch.from_numpy(s2s_batches(S2S_STEPS + 1, seed=17)).cuda()
    loss_fn = lambda model, b: s2s_loss(ht, model, b)  # noqa: E731
    want = flash_step_counts(S2S_BASE["enc_depth"], S2S_BASE["dec_depth"])
    rec = _train(ht, m, opt, data[:S2S_STEPS], loss_fn, want, "Seq2SeqTransformer training")
    tokens = S2S_BATCH * S2S_SEQ
    print(json.dumps({"phase": "nn_surface", "check": "Seq2SeqTransformer training", **S2S_BASE, "params": n_params,
                      "dtype": "float32", "batch": [S2S_BATCH, S2S_SEQ], "optimizer": "adam", "lr": LM_LR,
                      "steps": S2S_STEPS, **{k: v for k, v in rec.items() if k not in ("drop_share", "steady_s")},
                      "target_tokens_per_s": tokens / rec["steady_s"],
                      "source_and_target_tokens_per_s": 2 * tokens / rec["steady_s"],
                      "flash_launches_per_step": want, "card": smi}), flush=True)
    m.eval()  # dropout off: the same function through the kernels and their plain versions
    batch = data[S2S_STEPS]
    lm_step_vs_plain(ht, m, batch, MHA_KERNELS, "Seq2SeqTransformer", loss_fn=loss_fn, want=want, floor=ROW_FLOOR)
    with torch.no_grad():
        dec_in = torch.nn.functional.pad(batch[:, :-1], (1, 0), value=0)[:, :S2S_SHORT]
        before = dict(fa.launch_counts)
        logits, sec = _synced_s(lambda: m(batch, dec_in))
        counts = {k: fa.launch_counts[k] - before[k] for k in before}
        _path_counts("Seq2SeqTransformer, a shorter target", counts, ("flash_fwd",),
                     flash_step_counts(S2S_BASE["enc_depth"], S2S_BASE["dec_depth"], equal_cross=False)["flash_fwd"])
        with mock.patch.object(fa, "flash_fwd", fa._torch_flash_fwd):
            plain = m(batch, dec_in)
        rel = _rel_err(logits, plain)
    print(json.dumps({"phase": "nn_surface", "check": "Seq2SeqTransformer forward, target 192 (dense cross path)",
                      "source": S2S_SEQ, "target": S2S_SHORT, "ms": sec * 1e3, "launch_counts": counts,
                      "logits_rel_err_vs_plain": rel, "rtol": S2S_LOGIT_RTOL, "device": str(logits.device),
                      "card": smi}), flush=True)
    if not rel <= S2S_LOGIT_RTOL or logits.device.type != "cuda":
        fail(f"the 192-target forward vs plain: {rel}")
    src = batch
    m.generate(src[:2], 4)  # warm-up
    before = dict(fa.launch_counts)
    torch.cuda.reset_peak_memory_stats()
    ys, g_s = _synced_s(lambda: m.generate(src, S2S_NEW))
    g_counts = {k: fa.launch_counts[k] - before[k] for k in before}
    # the encoder runs once (its flash forwards); the decode steps launch no flash kernel
    _path_counts("Seq2SeqTransformer.generate", g_counts, ("flash_fwd",), S2S_BASE["enc_depth"])
    g_peak = torch.cuda.max_memory_allocated()
    yb, b_s = _synced_s(lambda: m.beam_search(src, S2S_NEW, beam_width=S2S_BEAM))
    for label, out in (("generate", ys), ("beam_search", yb)):
        if tuple(out.shape) != (S2S_BATCH, 1 + S2S_NEW) or not bool((out[:, 0] == 0).all()) or \
                int(out.min()) < 0 or int(out.max()) >= V or not out.is_cuda:
            fail(f"Seq2SeqTransformer.{label}: {tuple(out.shape)} on {out.device}, range [{int(out.min())}, "
                 f"{int(out.max())}]")
    with torch.no_grad():
        agree = greedy_agreement(ys[:, 1:], m(src, ys[:, :-1].long()))
    print(json.dumps({"phase": "nn_surface", "check": "Seq2SeqTransformer decoding", "batch": S2S_BATCH,
                      "source": S2S_SEQ, "new_tokens": S2S_NEW, "greedy_s": g_s,
                      "greedy_tokens_per_s": S2S_BATCH * S2S_NEW / g_s, "beam_width": S2S_BEAM, "beam_s": b_s,
                      "beam_tokens_per_s": S2S_BATCH * S2S_NEW / b_s, "greedy_peak_mem_bytes": g_peak,
                      "generate_launch_counts": g_counts, "greedy_vs_teacher_forced_argmax": agree,
                      "tie_rtol": GREEDY_TIE_RTOL, "card": smi}), flush=True)
    if agree["not_near_tie"]:
        fail(f"greedy decoding is not the teacher-forced argmax: {agree}")
    del m, opt, data
    torch.cuda.empty_cache()


def moe_lm(ht, smi: str, dense_peak=None) -> None:
    """Phase 11b's MoE LM: training with the load-balance loss, the dropped
    share of each step, the peak memory beside the dense LM's of phase 6
    (``dense_peak``), and generation through ``decode_apply``."""
    import numpy as np
    import torch

    from heat_tpu_torch.ops import flash_attention as fa

    torch.manual_seed(0)
    lm = ht.nn.models.TransformerLM(**LM_MOE)
    n_params = sum(p.numel() for p in lm.parameters())
    n_experts = sum(p.numel() for b in lm.blocks for n, p in b.ff.named_parameters() if n != "router")
    opt = ht.optim.DataParallelOptimizer("adam", lm.parameters(), lr=LM_LR)
    batches = torch.from_numpy(lm_batches(MOE_STEPS + 1, seed=11)).cuda()  # phase 6's batches
    rec = _train(ht, lm, opt, batches[:MOE_STEPS], lambda m, b: lm_loss(ht, m, b),
                 flash_step_counts(LM["depth"]), "TransformerLM(num_experts=8) training",
                 aux=lambda: MOE_AUX * sum(b.ff.aux_loss for b in lm.blocks),
                 stats=lambda: drop_share([b.ff.route_stats for b in lm.blocks]))
    cap = lm.blocks[0].ff._capacity(LM_BATCH * LM_SEQ)
    print(json.dumps({"phase": "nn_surface", "check": "TransformerLM(num_experts=8) training", **LM_MOE,
                      "params": n_params, "expert_params": n_experts, "capacity": cap, "dtype": "float32",
                      "batch": [LM_BATCH, LM_SEQ + 1], "aux_coef": MOE_AUX,
                      **{k: v for k, v in rec.items() if k != "steady_s"},
                      "train_tokens_per_s": LM_BATCH * LM_SEQ / rec["steady_s"], "dense_lm_peak_mem_bytes": dense_peak,
                      "card": smi}), flush=True)
    lm.eval()
    prompt = torch.from_numpy(np.random.default_rng(12).integers(0, LM["vocab_size"], (LM_BATCH, PROMPT))).cuda()
    lm.generate(prompt[:, :8], 4)  # warm-up
    before = dict(fa.launch_counts)
    out, sec = _synced_s(lambda: lm.generate(prompt, MOE_NEW))
    counts = {k: fa.launch_counts[k] - before[k] for k in before}
    if any(counts.values()) or tuple(out.shape) != (LM_BATCH, PROMPT + MOE_NEW) or \
            not torch.equal(out[:, :PROMPT].long(), prompt) or not out.is_cuda:
        fail(f"the MoE LM's generation: launches {counts}, shape {tuple(out.shape)}")
    print(json.dumps({"phase": "nn_surface", "check": "TransformerLM(num_experts=8) generation (decode_apply)",
                      "dtype": "float32", "prompt": [LM_BATCH, PROMPT], "new_tokens": MOE_NEW, "seconds": sec,
                      "tokens_per_s": LM_BATCH * MOE_NEW / sec, "launch_counts": counts, "card": smi}), flush=True)
    del lm, opt, batches
    torch.cuda.empty_cache()


def remat_lm(ht, smi: str) -> None:
    """Phase 11b's remat check: phase 6's dense LM, REMAT_STEPS Adam steps
    with and without checkpointing from the same weights, one model on the
    card at a time; equal losses and gradients, remat's peak lower."""
    import torch

    from heat_tpu_torch.ops import flash_attention as fa

    batches = torch.from_numpy(lm_batches(REMAT_STEPS, seed=11)).cuda()
    torch.manual_seed(0)
    init = {k: v.cpu() for k, v in ht.nn.models.TransformerLM(**LM).state_dict().items()}
    runs = {}
    for remat in (False, True):
        torch.manual_seed(0)
        lm = ht.nn.models.TransformerLM(**LM, remat=remat)
        lm.load_state_dict(init)
        opt = ht.optim.DataParallelOptimizer("adam", lm.parameters(), lr=LM_LR)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, step_s, grads = [], [], []
        for step in range(REMAT_STEPS):
            before = dict(fa.launch_counts)
            t0 = time.perf_counter()
            loss = lm_loss(ht, lm, batches[step])
            opt.zero_grad()
            loss.backward()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            _path_counts(f"remat={remat}, step {step}", {k: fa.launch_counts[k] - before[k] for k in before},
                         MHA_KERNELS, flash_step_counts(LM["depth"], remat=remat))
            losses.append(float(loss.detach()))
            grads.append({n: p.grad.detach().cpu() for n, p in lm.named_parameters()})
            opt.step()
        runs[remat] = {"losses": losses, "grads": grads, "peak": torch.cuda.max_memory_allocated(),
                       "step_ms": [t * 1e3 for t in step_s]}
        del lm, opt
        torch.cuda.empty_cache()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(runs[True]["losses"], runs[False]["losses"]))
    worst = max(((f"step {i}: {n}", float((g[n] - want).abs().max()) / max(float(want.abs().max()), 1e-30))
                 for i, (g, w) in enumerate(zip(runs[True]["grads"], runs[False]["grads"])) for n, want in w.items()),
                key=lambda t: t[1])
    print(json.dumps({"phase": "nn_surface", "check": "TransformerLM remat=True vs remat=False", **LM,
                      "steps": REMAT_STEPS, "losses": runs[True]["losses"], "loss_rel_err": loss_rel,
                      "worst_grad": worst[0], "worst_grad_rel_err": worst[1], "rtol": REMAT_RTOL,
                      "peak_mem_bytes_remat": runs[True]["peak"], "peak_mem_bytes_no_remat": runs[False]["peak"],
                      "step_ms_remat": runs[True]["step_ms"], "step_ms_no_remat": runs[False]["step_ms"],
                      "launches_per_step_remat": flash_step_counts(LM["depth"], remat=True), "card": smi}),
          flush=True)
    if not loss_rel <= REMAT_RTOL or not worst[1] <= REMAT_RTOL:
        fail(f"remat vs no remat: loss {loss_rel}, gradient {worst}")
    if not runs[True]["peak"] < runs[False]["peak"]:
        fail(f"remat's peak {runs[True]['peak']} is not below {runs[False]['peak']}")


def _tensors(out) -> list:
    import torch

    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _tensors(o)]


def _fwd_bwd(module, inputs, fixed, cots, device, dtype) -> tuple:
    """(outputs, gradients by name) of one forward of ``module`` (copied to
    ``device`` and ``dtype`` unless it is on the card in them) on ``inputs`` (the float ones not in ``fixed``
    differentiated) and one backward of the cotangents ``cots`` (None: draw
    them, seeded); and the cotangents."""
    import copy

    import torch

    p0 = next(module.parameters(), None)
    same = p0 is None or (p0.device.type == device.type and p0.dtype == dtype)
    m = module if same and device.type == "cuda" else copy.deepcopy(module).to(device, dtype)
    m.zero_grad(set_to_none=True)
    xs = [(x.detach().to(device, dtype) if x.is_floating_point() else x.detach().to(device)).requires_grad_(
        i not in fixed and x.is_floating_point()) for i, x in enumerate(inputs)]
    outs = _tensors(m(*xs))
    if cots is None:
        g = torch.Generator(device="cuda").manual_seed(29)
        cots = [torch.randn(o.shape, generator=g, device="cuda") for o in outs]
    live = [(o, c.to(device, dtype)) for o, c in zip(outs, cots) if o.requires_grad]
    if live:
        torch.autograd.backward([o for o, _ in live], [c for _, c in live])
    grads = {f"d_input{i}": x.grad for i, x in enumerate(xs) if x.requires_grad}
    grads.update({f"d_{n}": p.grad for n, p in m.named_parameters()})
    return outs, grads, cots


def _rel_errs(got, want) -> dict:
    """{name: max |got - want| / max |want|} over the outputs and gradients (lists and dicts of tensors)."""
    got = {**{f"out{i}": o for i, o in enumerate(got[0])}, **got[1]}
    want = {**{f"out{i}": o for i, o in enumerate(want[0])}, **want[1]}
    errs = {}
    for name, b in want.items():
        a = got[name]
        if a is None or b is None:
            errs[name] = None if (a is None) == (b is None) else float("inf")
        else:
            errs[name] = float((a.detach().double().cpu() - b.detach().double().cpu()).abs().max()) / max(
                float(b.detach().abs().max()), 1e-30)
    return errs


def layer_vs_float64(label: str, module, inputs, smi: str, fixed=(), reference: str = "cpu", rows: int = 0,
                     float32_floor: bool = False) -> dict:
    """One forward and backward of ``module`` (float32, on the card, under
    ``_full_float32``, in evaluation mode) against a float64 copy of it on
    the CPU (or, with ``reference='cuda'``, on the card, where the CPU's
    float64 would take minutes, and the first ``rows`` batch rows of the
    output also against the CPU's float64): outputs, the gradients of the
    float inputs (those not in ``fixed``) and of every parameter, each
    within LAYER_RTOL of its largest magnitude; every output on the card;
    the second of two passes timed.  ``float32_floor``: where float32 arithmetic itself cannot meet
    LAYER_RTOL (CTC's log-space alignment), a tensor is held to twice the
    error of the same module in float32 on the CPU instead, when that is
    larger.  Prints and returns the row."""
    import copy

    import torch

    from heat_tpu_torch.linalg.basics import _full_float32

    module.eval()  # RReLU's evaluation slope: one function on both sides
    with _full_float32():
        _fwd_bwd(module, inputs, fixed, None, torch.device("cuda"), torch.float32)  # warm-up (cuDNN's plans)
        (card, sec) = _synced_s(lambda: _fwd_bwd(module, inputs, fixed, None, torch.device("cuda"), torch.float32))
    dev64 = torch.device("cuda") if reference == "cuda" else torch.device("cpu")
    ref = _fwd_bwd(module, inputs, fixed, card[2], dev64, torch.float64)
    errs = _rel_errs(card, ref)
    tol = dict.fromkeys(errs, LAYER_RTOL)
    if float32_floor:
        cpu32 = _rel_errs(_fwd_bwd(module, inputs, fixed, card[2], torch.device("cpu"), torch.float32), ref)
        tol = {k: max(LAYER_RTOL, 2.0 * (cpu32[k] or 0.0)) for k in errs}
    if rows:  # the first rows against the CPU's float64 too
        cpu = copy.deepcopy(module).cpu().double()
        with torch.no_grad():
            head = _tensors(cpu(*[x.detach()[:rows].cpu().double() for x in inputs]))[0]
        errs["out0_rows_vs_cpu_float64"] = float((card[0][0].detach()[:rows].double().cpu() - head).abs().max()) / \
            max(float(head.abs().max()), 1e-30)
        tol["out0_rows_vs_cpu_float64"] = LAYER_RTOL
    bad = {k: (e, tol[k]) for k, e in errs.items() if e is not None and not e <= tol[k]}
    on_card = all(o.device.type == "cuda" for o in card[0])
    row = {"phase": "nn_surface", "check": label, "shapes": [list(x.shape) for x in inputs],
           "forward_backward_ms": sec * 1e3, "worst_rel_err": max((e for e in errs.values() if e is not None),
                                                                  default=0.0),
           "rtol": LAYER_RTOL, "reference": f"float64 on the {'card' if reference == 'cuda' else 'CPU'}",
           "outputs_on_card": on_card, "peak_mem_bytes": torch.cuda.max_memory_allocated(), "card": smi}
    if float32_floor:
        row.update(rel_errs=errs, tolerances=tol)
    print(json.dumps(row), flush=True)
    if bad or not on_card:
        fail(f"{label}: {bad}, outputs on the card: {on_card}")
    return row


def _layer_cases(ht):
    """(label, module, inputs, options) of the layer families at users' sizes, inputs on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(31)
    rn = lambda *s: torch.randn(s, generator=g, device="cuda")  # noqa: E731
    un = lambda *s: torch.rand(s, generator=g, device="cuda") * 0.9 + 0.05  # noqa: E731
    sign = lambda *s: torch.where(un(*s) < 0.5, -1.0, 1.0)  # noqa: E731
    X = rn(4096, 1024)
    nn = ht.nn
    cases = [
        ("LSTM(512, 1024, num_layers=2)", nn.LSTM(512, 1024, num_layers=2), [rn(64, 256, 512)],
         {"reference": "cuda", "rows": 2}),
        ("GRU(512, 1024, num_layers=2)", nn.GRU(512, 1024, num_layers=2), [rn(64, 256, 512)],
         {"reference": "cuda", "rows": 2}),
        ("Conv3d(16, 32, 3)", nn.Conv3d(16, 32, 3), [rn(8, 16, 32, 64, 64)], {}),
        ("ConvTranspose2d(64, 32, 4, stride=2, padding=1)", nn.ConvTranspose2d(64, 32, 4, stride=2, padding=1),
         [rn(32, 64, 64, 64)], {}),
        ("EmbeddingBag(32768, 512, mode='mean')", nn.EmbeddingBag(32768, 512, mode="mean"),
         [torch.randint(0, 32768, (65536,), generator=g, device="cuda"),
          torch.arange(0, 65536, 16, device="cuda")], {"fixed": (0, 1)}),
    ]
    T, N, C, S = 256, 32, 64, 40
    lp = torch.log_softmax(rn(T, N, C), -1)
    cases.append(("CTCLoss (256, 32, 64)", nn.CTCLoss(), [lp, torch.randint(1, C, (N, S), generator=g, device="cuda"),
                                                          torch.full((N,), T, device="cuda"),
                                                          torch.randint(10, S + 1, (N,), generator=g, device="cuda")],
                  {"fixed": (1, 2, 3), "float32_floor": True}))
    for name in ht.nn.activations.__all__:
        mod = {"Threshold": lambda: nn.Threshold(0.1, -2.0)}.get(name, getattr(nn, name))()
        cases.append((f"{name} (4096, 1024)", mod, [X], {}))
    for name in ("Softmax", "LogSoftmax", "Softmin"):
        cases.append((f"{name} (4096, 1024)", getattr(nn, name)(), [X], {}))
    shapes = {1: (4096, 1024), 2: (4, 1024, 1024), 3: (4, 64, 128, 128)}
    for name in ht.nn.padshuffle.__all__:
        if "Pad" in name:
            n = int(name[-2])
            args = ((3, 5) * n,) + ((0.5,) if name.startswith("Constant") else ())
            cases.append((f"{name}{args} {shapes[n]}", getattr(nn, name)(*args), [rn(*shapes[n])], {}))
    cases += [("PixelShuffle(2) (16, 256, 32, 32)", nn.PixelShuffle(2), [rn(16, 256, 32, 32)], {}),
              ("PixelUnshuffle(2) (16, 64, 64, 64)", nn.PixelUnshuffle(2), [rn(16, 64, 64, 64)], {}),
              ("ChannelShuffle(4) (16, 256, 32, 32)", nn.ChannelShuffle(4), [rn(16, 256, 32, 32)], {}),
              ("AdaptiveMaxPool1d(256) (4, 1024, 1024)", nn.AdaptiveMaxPool1d(256), [rn(4, 1024, 1024)], {}),
              ("AdaptiveMaxPool2d(16) (16, 256, 32, 32)", nn.AdaptiveMaxPool2d(16), [rn(16, 256, 32, 32)], {}),
              ("AdaptiveMaxPool3d(4) (4, 64, 16, 32, 32)", nn.AdaptiveMaxPool3d(4), [rn(4, 64, 16, 32, 32)], {}),
              ("AdaptiveAvgPool3d(4) (4, 64, 16, 32, 32)", nn.AdaptiveAvgPool3d(4), [rn(4, 64, 16, 32, 32)], {})]
    Y, P, Q = rn(4096, 1024), un(4096, 1024), un(4096, 1024)
    labels = torch.randint(0, 1024, (4096,), generator=g, device="cuda")
    two = {"MSELoss": [X, Y], "L1Loss": [X, Y], "HuberLoss": [X, Y], "SmoothL1Loss": [X, Y],
           "BCELoss": [P, Q], "BCEWithLogitsLoss": [X, Q], "SoftMarginLoss": [X, sign(4096, 1024)],
           "HingeEmbeddingLoss": [X, sign(4096, 1024)], "KLDivLoss": [torch.log(P), Q],
           "PoissonNLLLoss": [X * 0.1, torch.floor(Q * 5)], "MultiLabelSoftMarginLoss": [X, torch.round(Q)],
           "CrossEntropyLoss": [X, labels], "NLLLoss": [torch.log_softmax(X, -1), labels],
           "MultiMarginLoss": [X, labels]}
    for name, ins in two.items():
        fixed = (1,)
        cases.append((f"{name} (4096, 1024)", getattr(nn, name)(), ins, {"fixed": fixed}))
    three = {"MarginRankingLoss": [rn(4096), rn(4096), sign(4096)],
             "CosineEmbeddingLoss": [X, Y, sign(4096)],
             "GaussianNLLLoss": [X, Y, P], "TripletMarginLoss": [X, Y, rn(4096, 1024)],
             "TripletMarginWithDistanceLoss": [X, Y, rn(4096, 1024)]}
    for name, ins in three.items():
        fixed = (1,) if name == "GaussianNLLLoss" else (2,) if name in ("MarginRankingLoss",
                                                                         "CosineEmbeddingLoss") else ()
        cases.append((f"{name} (4096, 1024)", getattr(nn, name)(), ins, {"fixed": fixed}))
    mlm_t = torch.randint(-1, 64, (256, 64), generator=g, device="cuda")
    cases.append(("MultiLabelMarginLoss (256, 64)", nn.MultiLabelMarginLoss(), [rn(256, 64), mlm_t],
                  {"fixed": (1,)}))
    return cases


def layer_families(ht, smi: str) -> float:
    """Phase 11b's layer families at users' sizes (``_layer_cases``), each
    through ``layer_vs_float64``; returns the seconds."""
    import torch

    t0 = time.perf_counter()
    torch.manual_seed(0)
    for label, module, inputs, opts in _layer_cases(ht):
        layer_vs_float64(label, module, inputs, smi, **opts)
        del module
    torch.cuda.empty_cache()
    return time.perf_counter() - t0


def nn_surface_world_one(ht, smi: str, dense_peak=None) -> float:
    """Phase 11b at world size 1 (``dense_peak``: phase 6's training peak
    memory); returns its seconds."""
    t0 = time.perf_counter()
    seq2seq_base(ht, smi)
    moe_lm(ht, smi, dense_peak)
    remat_lm(ht, smi)
    layers_s = layer_families(ht, smi)
    sec = time.perf_counter() - t0
    print(json.dumps({"phase": "nn_surface_world_one", "seconds": sec, "layer_families_seconds": layers_s,
                      "card": smi}), flush=True)
    return sec


def nn_two_rank_cases(ht, comm, rank: int) -> dict:
    """Phase 11b on this rank of 2 (the ring phase's ranks): the MoE LM at
    depth 2 with the ring and expert parallelism together (capacity 4.0:
    nothing drops), ``Pipelined`` of 8 transformer blocks over the 2 stages,
    and ``transformer_decoder`` over a ragged (3, 2) split, each against the
    same model at world size 1 on this rank (the same seed, the same
    weights).  Returns each case's worst relative error and seconds."""
    import torch

    from heat_tpu_torch.nn import moe as moe_mod
    from heat_tpu_torch.nn.models import _TransformerBlock

    out = {}
    rel = lambda a, b: float((a - b).detach().abs().max()) / max(float(b.detach().abs().max()), 1e-30)  # noqa: E731
    # the MoE LM: ring + EP against world size 1
    cfg = dict(LM_MOE, depth=2, moe_capacity_factor=4.0)
    torch.manual_seed(0)
    ep = ht.nn.models.TransformerLM(**cfg, comm=comm)
    torch.manual_seed(0)
    one = ht.nn.models.TransformerLM(**cfg)
    batch = torch.from_numpy(lm_batches(1, 19, RING_BATCH, LM_SEQ)[0]).cuda()
    lo, n, _ = comm.chunk((LM_SEQ,), 0)
    rep, _ = moe_mod.split_parameters(ep)
    t0 = time.perf_counter()
    loss_r = _ring_step(ht, ep, comm, batch, lo, lo + n[0], params=rep)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    loss_1 = lm_loss(ht, one, batch)
    loss_1.backward()
    worst = ("", 0.0)
    for (name, p), q in zip(ep.named_parameters(), one.parameters()):
        want = q.grad
        mod = ep.get_submodule(name.rsplit(".", 1)[0]) if "." in name else ep
        if isinstance(mod, ht.nn.MoE) and mod.sharded and name.rsplit(".", 1)[1] != "router":
            want = want[mod.expert_offset: mod.expert_offset + mod.local_experts]
        e = rel(p.grad, want)
        if e > worst[1]:
            worst = (name, e)
    out["moe_lm"] = {"loss": loss_r, "world_one_loss": float(loss_1.detach()), "worst_grad": worst, "seconds": sec,
                     "sharded": [b.ff.sharded for b in ep.blocks], "tokens": [RING_BATCH, LM_SEQ]}
    del ep, one
    # Pipelined: 8 blocks over the 2 stages, against the same 8 blocks in order
    torch.manual_seed(0)
    seq = torch.nn.ModuleList(_TransformerBlock(512, 8) for _ in range(8))
    pm = ht.nn.Pipelined(_TransformerBlock(512, 8), 8, comm, n_microbatches=4)
    for i, b in enumerate(pm.blocks):
        b.load_state_dict(seq[rank * 4 + i].state_dict())
    g = torch.Generator(device="cuda").manual_seed(23)
    x, w = (torch.randn((16, 256, 512), generator=g, device="cuda") for _ in range(2))
    y, sec = _synced_s(lambda: pm(x))
    (y * w).sum().backward()
    h = x
    for b in seq:
        h = b(h)
    (h * w).sum().backward()
    grads = max(rel(p.grad, q.grad) for i, b in enumerate(pm.blocks)
                for p, q in zip(b.parameters(), seq[rank * 4 + i].parameters()))
    out["pipelined"] = {"output": rel(y, h), "stage_grads": grads, "forward_s": sec, "on_card": y.is_cuda}
    del seq, pm
    # the decoder over a ragged (3, 2) split of a 5-position target and memory
    torch.manual_seed(0)
    dec = ht.nn.models.transformer_decoder(512, 8, depth=2, comm=comm)
    one = ht.nn.models.transformer_decoder(512, 8, depth=2)
    one.load_state_dict(dec.state_dict())
    x, mem, w = (torch.randn((4, 5, 512), generator=g, device="cuda") for _ in range(3))
    lo, n, _ = comm.chunk((5,), 0)
    part = slice(lo, lo + n[0])
    y = dec(x[:, part], mem[:, part])
    (y * w[:, part]).sum().backward()
    y1 = one(x, mem)
    (y1 * w).sum().backward()
    full = comm.Allgatherv(y.detach(), 1)
    grads = max(rel(comm.Allreduce(p.grad.clone()), q.grad) for p, q in zip(dec.parameters(), one.parameters()))
    out["decoder"] = {"output": rel(full, y1), "grads": grads, "lengths": n[0]}
    return out


def nn_two_ranks_check(results: dict, smi: str) -> None:
    """Prints phase 11b's two-rank lines and fails where a case is off."""
    for rank, res in sorted(results.items()):
        nn = res["nn"]
        m = nn["moe_lm"]
        loss_rel = abs(m["loss"] - m["world_one_loss"]) / abs(m["world_one_loss"])
        rows = [("TransformerLM(num_experts=8, depth=2, comm): ring + expert parallelism",
                 {**m, "loss_rel_err": loss_rel}, max(loss_rel, m["worst_grad"][1])),
                ("Pipelined(_TransformerBlock(512, 8), depth=8, n_microbatches=4) on (16, 256, 512)",
                 nn["pipelined"], max(nn["pipelined"]["output"], nn["pipelined"]["stage_grads"])),
                ("transformer_decoder(512, 8, depth=2, comm) over a (3, 2) split", nn["decoder"],
                 max(nn["decoder"]["output"], nn["decoder"]["grads"]))]
        for label, row, worst in rows:
            print(json.dumps({"phase": "nn_surface_two_ranks", "check": label, "rank": rank, **row,
                              "worst_rel_err": worst, "rtol": NN_2R_RTOL, "vs": "world size 1 on the card",
                              "note": "2 processes on ONE card over gloo", "card": smi}), flush=True)
            if not worst <= NN_2R_RTOL:
                fail(f"rank {rank}: {label}: {worst}")
        if not all(m["sharded"]) or not nn["pipelined"]["on_card"]:
            fail(f"rank {rank}: experts not sharded or the pipeline left the card: {m['sharded']}")


# ---------------------------------------------------------------------- #
# ht.matmul (BASELINE config 0)
# ---------------------------------------------------------------------- #
def matmul_check(got, want) -> float:
    """max |got - want| over max |want|, in float64."""
    want = want.double()
    return float((got.double() - want).abs().max() / want.abs().max().clamp_min(1e-300))


def launched_kernels(fn, label: str) -> list:
    """The names of every device activity of one ``fn()`` (torch.profiler),
    sorted: kernels and any memory copies or sets."""
    prof, _ = profiled(fn, label)
    return sorted({e.key for e in device_events(prof)})


def matmul_world_one(ht, smi: str) -> None:
    """``ht.matmul`` of two (n, n) float32 ``ht.random.randn(..., split=0)``
    on the card at world size 1, n in MATMUL_SIZES: held against a float64
    product of the same tensors (MATMUL_RTOL) and, bit for bit, against
    ``torch.matmul`` of the local tensors; timed beside it; the same device
    kernels as ``torch.matmul`` and no copy."""
    import torch

    for n in MATMUL_SIZES:
        ht.random.seed(n)
        a = ht.random.randn(n, n, split=0)
        b = ht.random.randn(n, n, split=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()  # a, b and what earlier phases keep
        c = ht.matmul(a, b)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        if c.shape != (n, n) or c.split != 0 or not c.larray.is_cuda or c.dtype is not ht.float32:
            fail(f"ht.matmul at {n}: shape {c.shape}, split {c.split}, device {c.larray.device}, {c.dtype}")
        if not bool(torch.isfinite(c.larray).all()):
            fail(f"ht.matmul at {n}: non-finite values")
        err = matmul_check(c.larray, torch.matmul(a.larray.double(), b.larray.double()))
        if not err <= MATMUL_RTOL:
            fail(f"ht.matmul at {n} vs float64: {err} > {MATMUL_RTOL}")
        if not torch.equal(c.larray, torch.matmul(a.larray, b.larray)):
            fail(f"ht.matmul at {n} differs from torch.matmul of the local tensors")
        del c
        torch.cuda.empty_cache()
        kernels = launched_kernels(lambda: ht.matmul(a, b), f"ht.matmul at {n}")
        plain = launched_kernels(lambda: torch.matmul(a.larray, b.larray), f"torch.matmul at {n}")
        if kernels != plain or any("copy" in k.lower() or "memcpy" in k.lower() for k in kernels):
            fail(f"ht.matmul at {n} launched {kernels}, torch.matmul {plain}")
        reps = max(3, int(2e12 / n ** 3))
        ms = cuda_ms(lambda: ht.matmul(a, b), reps)
        torch_ms = cuda_ms(lambda: torch.matmul(a.larray, b.larray), reps)
        flops = 2.0 * n ** 3
        print(json.dumps({
            "phase": "main_path", "path": "ht.matmul (BASELINE config 0)", "shape": [n, n, n], "dtype": "float32",
            "splits": [0, 0], "result_split": 0, "world": 1, "cuda_ms": ms, "torch_matmul_ms": torch_ms,
            "tflops": flops / ms / 1e9, "share_of_f32_peak": flops / (ms * 1e-3) / PEAK_F32_FLOPS,
            "max_memory_allocated": peak, "allocated_before": before, "operand_bytes": 2 * a.larray.nbytes,
            "rel_err_vs_float64": err, "rel_tol": MATMUL_RTOL,
            "bitwise_equal_to_torch_matmul": True, "kernels": kernels, "card": smi}), flush=True)
        del a, b
        torch.cuda.empty_cache()


def _wall_ms(fn, comm, reps: int) -> float:
    """ms a call of ``fn`` on every rank: host clock over ``reps`` calls
    between barriers, the card synchronised (the gloo transfers block the
    host, so CUDA events behind a device sleep would not time them)."""
    import torch

    fn()
    torch.cuda.synchronize()
    comm.Barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    comm.Barrier()
    return (time.perf_counter() - t0) * 1e3 / reps


def matmul_rank(ht, rank: int) -> dict:
    """A rank's part of ``two_rank_world``: every matmul split case at
    4096^2 and the vector products, ``matmul_summa`` (ragged too),
    ``resplit_``, mismatched-split and broadcast ``+``, and ``sum``, ``max``,
    ``cumsum`` along both axes, each gathered and held against the world-1
    result on the card; the SUMMA and gather routes timed, with the
    communicator's traffic and transports."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    comm = ht.core.communication.get_comm()
    n = MATMUL_2R
    g = torch.Generator(device="cuda").manual_seed(11)
    A = torch.randn(n, n, generator=g, device="cuda")
    B = torch.randn(n, n, generator=g, device="cuda")
    v = torch.randn(n, generator=g, device="cuda")
    want = torch.matmul(A, B)  # ht.matmul at world size 1, bit for bit (the world-1 phase)
    res = {"rank": rank, "errs": {}, "splits": {}}

    def gathered(x):
        if not x.larray.is_cuda:
            fail(f"rank {rank}: a result left the card: {x.larray.device}")
        return x.resplit(None).larray

    for sa in (None, 0, 1):
        for sb in (None, 0, 1):
            c = ht.matmul(ht.array(A, split=sa), ht.array(B, split=sb))
            res["splits"][f"{sa},{sb}"] = c.split
            res["errs"][f"matmul {sa},{sb}"] = matmul_check(gathered(c), want)
    for name, (x, sx, y, sy, ref) in {
            "vector @ matrix 0,1": (v, 0, B, 1, torch.matmul(v, B)),
            "matrix @ vector 1,0": (A, 1, v, 0, torch.matmul(A, v))}.items():
        c = ht.matmul(ht.array(x, split=sx), ht.array(y, split=sy))
        res["splits"][name] = c.split
        res["errs"][name] = matmul_check(gathered(c), ref)
    for shape in ((n, n, n), MATMUL_RAGGED):
        gr = torch.Generator(device="cuda").manual_seed(sum(shape))
        x = torch.randn(shape[0], shape[1], generator=gr, device="cuda")
        y = torch.randn(shape[1], shape[2], generator=gr, device="cuda")
        c = ht.linalg.matmul_summa(ht.array(x, split=0), ht.array(y, split=0))
        res["splits"][f"summa {shape}"] = c.split
        res["errs"][f"summa {shape}"] = matmul_check(gathered(c), torch.matmul(x, y))

    x = ht.array(A, split=0)
    exact = []
    for axis in (1, None, 0):
        x.resplit_(axis)
        exact.append(x.split == axis and torch.equal(gathered(x), A))
    res["resplit_exact"] = exact
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res["errs"]["+ mismatched splits 0,1"] = matmul_check(
            gathered(ht.array(A, split=0) + ht.array(B, split=1)), A + B)
    res["errs"]["+ split 0 and replicated"] = matmul_check(gathered(ht.array(A, split=0) + ht.array(B)), A + B)
    res["errs"]["+ row vector split 0"] = matmul_check(gathered(ht.array(A, split=1) + ht.array(v, split=0)),
                                                       A + v)
    for axis in (0, 1):
        x = ht.array(A, split=0)
        res["errs"][f"sum axis {axis}"] = matmul_check(gathered(ht.sum(x, axis=axis)), A.sum(axis))
        res["errs"][f"max axis {axis}"] = matmul_check(gathered(ht.max(x, axis=axis)), A.amax(axis))
        res["errs"][f"cumsum axis {axis}"] = matmul_check(gathered(ht.cumsum(x, axis)), A.cumsum(axis))

    a, b = ht.array(A, split=0), ht.array(B, split=0)
    comm.reset_traffic()
    ht.linalg.matmul_summa(a, b)
    res["summa_traffic"] = comm.traffic()
    comm.reset_traffic()
    ht.matmul(a, b, method="gspmd")
    res["gather_traffic"] = comm.traffic()
    res["summa_ms"] = _wall_ms(lambda: ht.linalg.matmul_summa(a, b), comm, 3)
    res["gather_ms"] = _wall_ms(lambda: ht.matmul(a, b, method="gspmd"), comm, 3)
    res["transport"] = {op: comm.transport(A, op) for op in MATMUL_COLLECTIVES}
    return res


def matmul_two_ranks(smi: str, results: dict) -> None:
    """The two-rank matmul phase: checks what ``matmul_rank`` reported from
    each of 2 processes on this card over gloo (``results``) and prints rank
    0's line."""
    for rank, res in sorted(results.items()):
        bad = {k: e for k, e in res["errs"].items() if not e <= MATMUL_2R_RTOL}
        if bad:
            fail(f"rank {rank}: against world size 1 beyond {MATMUL_2R_RTOL}: {bad}")
        for case, split in res["splits"].items():
            want = MATMUL_SPLITS.get(case, 0)
            if split != want:
                fail(f"rank {rank}: matmul {case} split {split}, the table says {want}")
        if res["resplit_exact"] != [True, True, True]:
            fail(f"rank {rank}: resplit_ 0 -> 1 -> None -> 0 not exact: {res['resplit_exact']}")
    r0 = results[0]
    flops = 2.0 * MATMUL_2R ** 3
    print(json.dumps({
        "phase": "matmul_two_ranks", "note": "2 processes on ONE card over gloo: not a multi-card figure",
        "shape": [MATMUL_2R] * 3, "dtype": "float32", "ragged_summa": list(MATMUL_RAGGED),
        "rel_tol": MATMUL_2R_RTOL, "worst_rel_err": max(max(r["errs"].values()) for r in results.values()),
        "errs_rank0": r0["errs"], "splits": r0["splits"], "resplit_exact": r0["resplit_exact"],
        "summa_ms": r0["summa_ms"], "gather_route_ms": r0["gather_ms"],
        "summa_tflops_both_ranks": flops / r0["summa_ms"] / 1e9, "gather_tflops_both_ranks": flops / r0["gather_ms"] / 1e9,
        "summa_traffic": r0["summa_traffic"], "gather_traffic": r0["gather_traffic"], "transport": r0["transport"],
        "card": smi}), flush=True)


def pos_bound(kernel: str, B: int, Sq: int, Sk: int, d: int, live_pairs: int, itemsize: int):
    """(bound_ms, bound_by) of one positions launch: FLOP of its live (q, k)
    pairs at the dtype's peak vs every input read and output written once.
    The forward reads q, k, v and the positions and writes out and lse; dq
    reads q, k, v, dO, lse, dd and the positions and writes dq; dk/dv the
    same and writes dk and dv.  A block with no live pair needs only the
    positions and its outputs (zeros, and lse -1e30): nothing else is read."""
    flops = {"flash_pos_fwd": 4, "flash_pos_bwd_dq": 6, "flash_pos_bwd_dkv": 8}[kernel] * live_pairs * d
    # (q-side tensors, k-side tensors, float32 rows) read or written
    t_q, t_kv, r = {"flash_pos_fwd": (2, 2, 1), "flash_pos_bwd_dq": (3, 2, 2), "flash_pos_bwd_dkv": (2, 4, 2)}[kernel]
    if not live_pairs:  # outputs only: out + lse, dq, or dk + dv
        t_q, t_kv, r = {"flash_pos_fwd": (1, 0, 1), "flash_pos_bwd_dq": (1, 0, 0),
                        "flash_pos_bwd_dkv": (0, 2, 0)}[kernel]
    nbytes = (t_q * Sq + t_kv * Sk) * B * d * itemsize + r * B * Sq * 4 + (Sq + Sk) * 4
    t_ops = flops / (PEAK_F32_FLOPS if itemsize == 4 else PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def time_pos(dtype, reps: int, shape=POS_MAIN) -> dict:
    """{block: {kernel: times}} at the ring step's blocks of ``shape`` (B,
    Sq, Sk, d): each kernel, its plain version and the library call,
    ``scaled_dot_product_attention`` on (2, 8, S, d) views with a boolean
    mask built from the positions."""
    import torch

    from heat_tpu_torch.ops import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, Sq, Sk, d = shape
    out_rows = {}
    for block, (qo, ko) in POS_BLOCKS.items():
        q, k, v, do, g_lse, qpos, kpos = _pos_inputs(B, Sq, Sk, d, qo, ko, dtype, seed=7)
        s_valid = 2 * Sq
        args = (qpos, kpos, True, d**-0.5, s_valid, True)
        out, lse = fa.flash_pos_fwd(q, k, v, *args)
        dd = (do.float() * out.float()).sum(-1) - g_lse
        keep = (qpos[:, None] >= kpos[None, :]) & (kpos[None, :] < s_valid)  # True = attend
        live = B * int(keep.sum())
        q4, k4, v4, do4 = (t.view(-1, LM["num_heads"], t.shape[1], d) for t in (q, k, v, do))
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q4, k4, v4))
        lib_out = sdpa(qg, kg, vg, attn_mask=keep)

        def lib_fwd():
            return sdpa(q4, k4, v4, attn_mask=keep)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (qg, kg, vg), do4, retain_graph=True)

        lib_bwd_ms = cuda_ms(lib_bwd, reps)
        runs = {
            "flash_pos_fwd": (lambda: fa.flash_pos_fwd(q, k, v, *args), lambda: fa._torch_flash_pos_fwd(q, k, v, *args),
                              cuda_ms(lib_fwd, reps)),
            "flash_pos_bwd_dq": (lambda: fa.flash_pos_bwd_dq(q, k, v, do, lse, dd, *args),
                                 lambda: fa._torch_flash_pos_bwd_dq(q, k, v, do, lse, dd, *args), lib_bwd_ms),
            "flash_pos_bwd_dkv": (lambda: fa.flash_pos_bwd_dkv(q, k, v, do, lse, dd, *args),
                                  lambda: fa._torch_flash_pos_bwd_dkv(q, k, v, do, lse, dd, *args), lib_bwd_ms),
        }
        kernels = {"forward": device_kernels(lib_fwd), "backward": device_kernels(lib_bwd)}
        for name, (run, plain, lib_ms) in runs.items():
            b_ms, b_by = pos_bound(name, B, Sq, Sk, d, live, q.element_size())
            lib_kernels = kernels["forward" if name == "flash_pos_fwd" else "backward"]
            out_rows.setdefault(name, {})[block] = {
                "live_pairs": live, "ms": cuda_ms(run, reps), "plain_ms": cuda_ms(plain, 2), "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms, "library_kernels": lib_kernels,
                "library_backend": sdpa_backend(lib_kernels)}
        del q, k, v, do, lib_out, qg, kg, vg
    return out_rows


def pos_rows(errs: dict) -> list:
    """The kernels line's rows of the positions kernels: float32 at the ring
    step's blocks (and bfloat16 beside), each block reported apart and the
    row's numbers the mean launch of the main path's mix of blocks; each
    row's ``launches`` is None until the ring's run fills it in."""
    import torch

    total = sum(POS_MIX.values())

    def mix(per_block: dict) -> dict:
        row = {key: sum(POS_MIX[b] * per_block[b][key] for b in POS_MIX) / total
               for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
        # bound by what bounds the block that adds most to the mix's bound
        row["bound_by"] = per_block[max(POS_MIX, key=lambda b: POS_MIX[b] * per_block[b]["bound_ms"])]["bound_by"]
        return row

    f32, bf16 = time_pos(torch.float32, 10), time_pos(torch.bfloat16, 10)
    wide = {dt: time_pos(getattr(torch, dt), 3, POS_WIDE) for dt in ("float32", "bfloat16")}
    d512 = {dt: time_pos(getattr(torch, dt), 2, POS_D512) for dt in ("float32", "bfloat16")}
    lib = ["scaled_dot_product_attention(attn_mask=positions mask) forward"] + \
        ["scaled_dot_product_attention(attn_mask=positions mask) backward: dq, dk and dv together"] * 2
    rows = []
    for name, line, lib_call in zip(POS_KERNELS, (235, 264, 298), lib):
        rows.append({
            "name": name, "route": "cuda", "source": flash_sources(name)["float32"], "cores": flash_cores(name),
            "sources": flash_sources(name), "bodies": flash_bodies(name),
            "replaces": f"heat_tpu/ops/flash_attention.py:{line}", "launches": None,
            "max_abs_err": max(e[name] for e in errs["float32"].values()), **mix(f32[name]),
            "shape": list(POS_MAIN), "causal": True, "mix": POS_MIX, "blocks": f32[name], "library_call": lib_call,
            "bfloat16": {**mix(bf16[name]), "max_abs_err": max(e[name] for e in errs["bfloat16"].values()),
                         "blocks": bf16[name]},
            **{f"d256_{dt}": {**mix(timed[name]), "shape": list(POS_WIDE)} for dt, timed in wide.items()},
            **{f"d512_{dt}": {**mix(timed[name]), "shape": list(POS_D512), **wide_route(name, POS_D512[3], dt),
                              "library_backend": timed[name]["diagonal"]["library_backend"], "blocks": timed[name],
                              "max_abs_err": max(e[name] for e in errs[f"d512_{dt}"].values())}
               for dt, timed in d512.items()},
            "check": "pass",
        })
    return rows


# ---------------------------------------------------------------------- #
# tall-skinny QR/SVD (BASELINE config 1), the solvers, and cdist
# ---------------------------------------------------------------------- #
def qr_flops(m: int, n: int, world: int = 1) -> dict:
    """Operation counts of a QR of an (m, n) matrix over ``world`` ranks: the
    standard counts of Householder's R and Q (LAPACK's geqrf + orgqr, 4mn^2
    - 4n^3/3) and of R alone (2mn^2 - 2n^3/3), and what the port's routes
    execute in m.n^2 products of 2mn^2 each: CholeskyQR2 two Grams and two
    Q products (four), without Q one less (the second round forms no Q),
    the SVD one more (U = Q U_R); the Householder route the standard count.
    On more than one rank TSQR's merge adds Q1 Q2 to every route with a Q
    (one rank skips the merge)."""
    product = 2.0 * m * n * n
    merge = product if world > 1 else 0.0
    standard = 4.0 * m * n * n - 4.0 * n ** 3 / 3
    return {"standard": standard, "standard_r": 2.0 * m * n * n - 2.0 * n ** 3 / 3,
            "cholqr2": 4 * product + merge, "cholqr2_r": 3 * product, "svd": 5 * product + merge,
            "householder": standard + merge}


def qr_errors(a, q, r, s=None, rows: int = QR_CHECK_ROWS) -> dict:
    """||A - Q R||_F / ||A||_F (with ``s``: ||A - Q diag(s) R||, an SVD's
    U, S and V^T), max |Q^T Q - I| and, for a QR, max |tril(R, -1)|; in
    float64 over blocks of ``rows`` rows (no float64 copy of A or Q)."""
    import torch

    r64 = r.double() if s is None else s.double()[:, None] * r.double()
    resid = norm = 0.0
    gram = torch.zeros((q.shape[1], q.shape[1]), dtype=torch.float64, device=q.device)
    for lo in range(0, a.shape[0], rows):
        ab, qb = a[lo: lo + rows].double(), q[lo: lo + rows].double()
        resid += float((ab - qb @ r64).square().sum())
        norm += float(ab.square().sum())
        gram += qb.T @ qb
    eye = torch.eye(gram.shape[0], dtype=torch.float64, device=gram.device)
    errs = {"rel_err": (resid / norm) ** 0.5, "orth_err": float((gram - eye).abs().max())}
    if s is None:
        errs["tril_max"] = float(torch.tril(r, -1).abs().max()) if r.shape[0] > 1 else 0.0
    return errs


def align_signs(r, r_ref):
    """D = sign(diag R) sign(diag R_ref): the QR of one matrix is unique up
    to the signs of R's diagonal, so Q D and D R match Q_ref and R_ref."""
    import torch

    k = min(r.shape)
    d = torch.sign(torch.diagonal(r)[:k]) * torch.sign(torch.diagonal(r_ref)[:k])
    return torch.where(d == 0, torch.ones_like(d), d)


def rel_max(got, want) -> float:
    """max |got - want| over max |want|, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def kernel_times(fn, reps: int = 3) -> list:
    """Each CUDA kernel of ``fn()`` with its device ms a call and launches a
    call (torch.profiler over ``reps`` calls), by device time."""
    prof, _ = profiled(lambda: [fn() for _ in range(reps)], "kernel_times")
    evts = [e for e in device_events(prof) if e.self_device_time_total > 0]
    return [{"kernel": e.key[:120], "ms": e.self_device_time_total / 1e3 / reps, "launches": e.count / reps}
            for e in sorted(evts, key=lambda e: -e.self_device_time_total)]


def wall_ms(fn, reps: int) -> float:
    """ms a call of ``fn`` by the host clock, the card synchronised: for
    calls that read a flag on the host mid-way (CholeskyQR2's check, cg's
    residual), whose device time has host gaps."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def qr_main(ht, smi: str) -> None:
    """BASELINE config 1 at full size, world size 1: ``ht.linalg.qr`` by
    CholeskyQR2 ('auto') and Householder, ``mode='r'``, and
    ``ht.linalg.svd`` of float32 ``ht.random.randn(1e6, 256, split=0)``,
    each timed (host clock, the card synchronised), its TFLOP/s by the
    standard count and by the route's executed products, its peak memory,
    its kernels under the profiler, and held against float64 on the card
    (QR_TOL); 'auto' again with the caller's matmul precision at "high"
    (TF32), which the products must not take; the Gram's and a Q
    product's GEMM alone; then solve_triangular and cg at SOLVE_N."""
    import torch

    m, n = QR_SHAPE
    flops = qr_flops(m, n)
    ht.random.seed(1)
    a = ht.random.randn(m, n, split=0)
    s64 = torch.linalg.svdvals(a.larray.double())
    routes = {
        "qr auto (CholeskyQR2)": (lambda: ht.linalg.qr(a), flops["cholqr2"], flops["standard"]),
        "qr householder": (lambda: ht.linalg.qr(a, method="householder"), flops["householder"], flops["standard"]),
        "qr auto mode='r'": (lambda: ht.linalg.qr(a, mode="r"), flops["cholqr2_r"], flops["standard_r"]),
        "svd": (lambda: ht.linalg.svd(a), flops["svd"], flops["standard"] + 2.0 * m * n * n),
    }
    for label, (fn, executed, standard) in routes.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        res = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        row = {"phase": "main_path", "path": f"ht.linalg.{label} (BASELINE config 1)", "shape": [m, n],
               "dtype": "float32", "split": 0, "world": 1}
        if label == "svd":
            u, s, v = res
            errs = qr_errors(a.larray, u.larray, v.larray.T, s=s.larray)
            errs["s_rel_err"] = rel_max(s.larray, s64)
            if u.split != 0 or v.split is not None or not u.larray.is_cuda:
                fail(f"svd: U split {u.split}, V split {v.split}, device {u.larray.device}")
        elif res.Q is None:
            r = res.R.larray
            errs = {"s_rel_err": rel_max(torch.linalg.svdvals(r.double()), s64),
                    "tril_max": float(torch.tril(r, -1).abs().max())}
        else:
            if res.Q.split != 0 or res.R.split is not None or not res.Q.larray.is_cuda:
                fail(f"{label}: Q split {res.Q.split}, R split {res.R.split}, device {res.Q.larray.device}")
            errs = qr_errors(a.larray, res.Q.larray, res.R.larray)
            errs["s_rel_err"] = rel_max(torch.linalg.svdvals(res.R.larray.double()), s64)
        del res
        bad = {k: e for k, e in errs.items() if not (e <= QR_TOL if k != "tril_max" else e == 0.0)}
        if bad:
            fail(f"{label} vs float64 beyond {QR_TOL}: {bad}")
        ms = wall_ms(fn, 3)
        row.update({"ms": ms, "tflops_standard": standard / ms / 1e9, "tflops_executed": executed / ms / 1e9,
                    "flops_standard": standard, "flops_executed": executed, "peak_mem_bytes": peak,
                    "input_bytes": a.larray.nbytes, "errors_vs_float64": errs, "tol": QR_TOL,
                    "kernels": kernel_times(fn, 2)[:6], "card": smi})
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()

    # the caller's TF32: the products must stay in full float32, and the setting must come back
    torch.set_float32_matmul_precision("high")
    try:
        q, r = ht.linalg.qr(a)
        kept = torch.get_float32_matmul_precision()
    finally:
        torch.set_float32_matmul_precision("highest")
    errs = qr_errors(a.larray, q.larray, r.larray)
    del q, r
    print(json.dumps({"phase": "qr_under_tf32_precision", "caller_precision": "high", "precision_after": kept,
                      "errors_vs_float64": errs, "tol": QR_TOL}), flush=True)
    if kept != "high" or not errs["orth_err"] <= QR_TOL or not errs["rel_err"] <= QR_TOL:
        fail(f"qr under the caller's 'high' precision: {errs}, precision after {kept}")

    x, eye = a.larray, torch.eye(n, device="cuda")
    gram = lambda: x.T @ x  # noqa: E731
    prod = lambda: x @ eye  # noqa: E731
    for label, fn in (("gram x^T x", gram), ("q product x L^-T", prod)):
        ms = cuda_ms(fn, 5)
        print(json.dumps({"phase": "qr_gemm", "gemm": label, "shape": [m, n], "ms": ms,
                          "tflops": 2.0 * m * n * n / ms / 1e9, "share_of_f32_peak": 2.0 * m * n * n / (ms * 1e-3)
                          / PEAK_F32_FLOPS, "kernels": kernel_times(fn, 2), "card": smi}), flush=True)
    del a, x
    torch.cuda.empty_cache()
    solver_main(ht, smi)


def solver_main(ht, smi: str) -> None:
    """``solve_triangular`` (blocked and native) and ``cg`` on SOLVE_N^2
    float32 systems on the card, against float64 solves (SOLVE_RTOL)."""
    import torch

    n = SOLVE_N
    g = torch.Generator(device="cuda").manual_seed(4)
    mat = torch.randn(n, n, generator=g, device="cuda")
    b = torch.randn(n, generator=g, device="cuda")
    upper = torch.triu(mat, 1) / n ** 0.5 + n ** 0.5 * torch.eye(n, device="cuda")  # diagonally dominant
    spd = mat @ mat.T / n + torch.eye(n, device="cuda")
    rows = []
    want = torch.linalg.solve_triangular(upper.double(), b.double()[:, None], upper=True)[:, 0]
    for blocked in (True, False):
        fn = lambda: ht.linalg.solve_triangular(ht.array(upper, split=0), ht.array(b, split=0), blocked=blocked)  # noqa
        rows.append({"solver": f"solve_triangular blocked={blocked}", "rel_err": rel_max(fn().larray, want),
                     "ms": wall_ms(fn, 3)})
    want = torch.linalg.solve(spd.double(), b.double())
    tol = 1e-4 * float(b.norm())
    fn = lambda: ht.linalg.cg(ht.array(spd, split=0), ht.array(b, split=0), tol=tol)  # noqa: E731
    rows.append({"solver": "cg", "tol": tol, "rel_err": rel_max(fn().larray, want), "ms": wall_ms(fn, 3)})
    print(json.dumps({"phase": "solvers", "n": n, "dtype": "float32", "split": 0, "world": 1, "rows": rows,
                      "rtol": SOLVE_RTOL, "card": smi}), flush=True)
    bad = [r for r in rows if not r["rel_err"] <= SOLVE_RTOL]
    if bad:
        fail(f"solvers vs float64 beyond {SOLVE_RTOL}: {bad}")


def cdist_bound_ms(n: int, m: int, d: int) -> tuple:
    """The least time of an (n, m) float32 distance matrix of d features:
    the result written once (and x, y read once) at PEAK_BYTES, against 2nmd
    operations at PEAK_F32_FLOPS; (ms, "bytes" or "operations")."""
    bytes_ms = 4.0 * (n * m + (n + m) * d) / PEAK_BYTES * 1e3
    ops_ms = 2.0 * n * m * d / PEAK_F32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def within_rtol(got, want, rtol: float = CDIST_RTOL) -> bool:
    """|got - want| <= rtol |want| at every entry, ``want`` in float64."""
    return bool(((got.double() - want).abs() <= rtol * want.abs()).all())


def rbf_want(d64, sigma: float = RBF_SIGMA):
    """The RBF kernel exp(-d^2 / 2 sigma^2) of float64 distances."""
    return (-d64.square() / (2.0 * sigma * sigma)).exp()


def cdist_main(ht, smi: str) -> None:
    """``ht.spatial.cdist`` (direct and quadratic expansion), ``manhattan``
    and ``rbf`` (at RBF_SIGMA) of x, y float32 CDIST_SHAPE split 0 at world
    size 1 (a 4 GiB result each): held on CDIST_SAMPLE rows against float64
    (CDIST_RTOL of each entry; the expansion CDIST_EXPANSION_ATOL of the
    largest distance), timed (CUDA events), beside the bound and
    ``torch.cdist``."""
    import torch

    n, d = CDIST_SHAPE
    ht.random.seed(2)
    x, y = ht.random.randn(n, d, split=0), ht.random.randn(n, d, split=0)
    idx = torch.randperm(n, generator=torch.Generator().manual_seed(0))[:CDIST_SAMPLE].to("cuda")
    xs, y64 = x.larray[idx].double(), y.larray.double()
    d64 = torch.cdist(xs, y64)
    bound, by = cdist_bound_ms(n, n, d)
    funcs = {
        "cdist": (lambda: ht.spatial.cdist(x, y), d64, within_rtol),
        "cdist quadratic_expansion": (lambda: ht.spatial.cdist(x, y, quadratic_expansion=True), d64,
                                      lambda g, w: float((g.double() - w).abs().max())
                                      <= CDIST_EXPANSION_ATOL * float(w.max())),
        "manhattan": (lambda: ht.spatial.manhattan(x, y), torch.cdist(xs, y64, p=1.0), within_rtol),
        "rbf": (lambda: ht.spatial.rbf(x, y, sigma=RBF_SIGMA), rbf_want(d64), within_rtol),
    }
    for label, (fn, want, ok) in funcs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        res = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        if res.shape != (n, n) or res.split != 0 or not res.larray.is_cuda:
            fail(f"{label}: shape {res.shape}, split {res.split}, device {res.larray.device}")
        got = res.larray[idx]
        err = (got.double() - want).abs()
        passed = ok(got, want)
        worst, worst_rel = float(err.max()), float((err / want.abs()).max())
        del res
        torch.cuda.empty_cache()
        ms = cuda_ms(fn, 3)
        library = None
        if label in ("cdist", "manhattan"):
            p = 2.0 if label == "cdist" else 1.0
            library = cuda_ms(lambda: torch.cdist(x.larray, y.larray, p=p), 3)
        print(json.dumps({"phase": "main_path", "path": f"ht.spatial.{label}", "shape": [n, n, d],
                          "dtype": "float32", "split": 0, "world": 1, "ms": ms, "bound_ms": bound, "bound_by": by,
                          "torch_cdist_ms": library, "max_abs_err_sampled": worst, "max_rel_err_sampled": worst_rel,
                          "sampled_rows": CDIST_SAMPLE,
                          "peak_mem_bytes": peak, "kernels": kernel_times(fn, 1)[:3], "card": smi}), flush=True)
        if not passed:
            fail(f"{label} vs float64 on {CDIST_SAMPLE} rows: worst {worst} (relative {worst_rel})")
        torch.cuda.empty_cache()
    del x, y
    torch.cuda.empty_cache()


def linalg_cases(ht) -> dict:
    """The two-rank phase's calls on the card, from inputs drawn on the card
    from one seed: ``cdist`` and ``cdist_ring`` at every (x.split, y.split)
    pair, ``tsqr`` (LINALG_2R_QR, and LINALG_2R_REPLICATED, whose ranks hold
    fewer rows than columns: the replicated path), ``svd``, ``hsvd_rank`` of
    an exact-rank input, the blocked ``solve_triangular``, ``cg`` (40 steps)
    and a boolean mask at split 0.  Each result gathered, as a CPU tensor;
    with the mask's split and this rank's rows."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(12)
    out = {}

    def whole(x):
        if not x.larray.is_cuda:
            fail(f"a result left the card: {x.larray.device}")
        return (x.resplit(None) if x.is_distributed() else x).larray.cpu()

    X = torch.randn(*LINALG_2R_CDIST[0], generator=g, device="cuda")
    Y = torch.randn(*LINALG_2R_CDIST[1], generator=g, device="cuda")
    for name, fn in (("cdist", ht.spatial.cdist), ("cdist_ring", ht.spatial.cdist_ring)):
        for sx in (None, 0, 1):
            for sy in (None, 0, 1):
                out[f"{name} {sx},{sy}"] = whole(fn(ht.array(X, split=sx), ht.array(Y, split=sy)))
    for shape in (LINALG_2R_QR, LINALG_2R_REPLICATED):
        q, r = ht.linalg.tsqr(ht.array(torch.randn(*shape, generator=g, device="cuda"), split=0))
        out[f"tsqr {shape}"] = [whole(q), whole(r)]
    u, s, v = ht.linalg.svd(ht.array(torch.randn(*LINALG_2R_QR, generator=g, device="cuda"), split=0))
    out["svd"] = [whole(u), whole(s), whole(v)]
    k = 8
    left = torch.linalg.qr(torch.randn(1000, k, generator=g, device="cuda"))[0]
    right = torch.linalg.qr(torch.randn(60, k, generator=g, device="cuda"))[0]
    low = left * torch.arange(2 * k, k, -1, device="cuda") @ right.T
    u, s, v, _ = ht.linalg.hsvd_rank(ht.array(low, split=0), k, compute_sv=True)
    out["hsvd_rank"] = [whole(u), whole(s), whole(v)]
    n = 512
    mat = torch.randn(n, n, generator=g, device="cuda")
    b = torch.randn(n, generator=g, device="cuda")
    up = torch.triu(mat, 1) / n ** 0.5 + n ** 0.5 * torch.eye(n, device="cuda")  # diagonally dominant
    out["solve_triangular blocked"] = whole(ht.linalg.solve_triangular(ht.array(up, split=0), ht.array(b, split=0),
                                                                        blocked=True))
    spd = mat @ mat.T / n + torch.eye(n, device="cuda")
    out["cg"] = whole(ht.linalg.cg(ht.array(spd, split=0), ht.array(b, split=0), maxit=40, tol=0.0))
    xr = ht.array(torch.arange(LINALG_2R_CDIST[0][0], device="cuda", dtype=torch.float32), split=0)
    sel = xr[xr > 600]
    out["mask"] = whole(sel)
    out["mask_split"], out["mask_lshape"] = sel.split, list(sel.lshape)
    return out


def compare_linalg(got: dict, want: dict) -> dict:
    """rel_max of each two-rank result against world size 1's: QR factors
    with their signs aligned (``align_signs``), SVDs by S and U diag(S) V^T
    (U and V are unique only up to signs and rotations within clusters of
    singular values)."""
    errs = {}
    for name, w in want.items():
        gv = got[name]
        if name.startswith("mask_"):
            continue
        if name.startswith("tsqr"):
            d = align_signs(gv[1], w[1])
            errs[f"{name} R"] = rel_max(d[:, None] * gv[1], w[1])
            errs[f"{name} Q"] = rel_max(gv[0] * d, w[0])
        elif name in ("svd", "hsvd_rank"):
            errs[f"{name} S"] = rel_max(gv[1], w[1])
            errs[f"{name} U S V^T"] = rel_max(gv[0] * gv[1] @ gv[2].T, w[0] * w[1] @ w[2].T)
        else:
            errs[name] = rel_max(gv, w)
    return errs


def _tensors_as(res: dict, conv) -> dict:
    """``res`` with each tensor (alone or in a list) passed through ``conv``."""
    return {k: [conv(t) for t in v] if isinstance(v, list) and v and not isinstance(v[0], int) else
            (conv(v) if not isinstance(v, (int, list, type(None))) else v) for k, v in res.items()}


def linalg_rank(ht, rank: int) -> dict:
    """A rank's part of ``two_rank_world``: ``linalg_cases``, reported."""
    import torch

    torch.set_float32_matmul_precision("highest")
    return _tensors_as(linalg_cases(ht), lambda t: t.numpy())  # by value: a shared tensor dies with its rank


def linalg_two_ranks(ht, smi: str, results: dict) -> None:
    """The two-rank linear algebra phase: ``linalg_cases`` at world size 1
    on this card against ``linalg_rank``'s in 2 processes on this card over
    gloo (``results``), each rank's held to world size 1's (LINALG_2R_TOL;
    the mask exactly, split 0); prints rank 0's line."""
    want = linalg_cases(ht)
    errs = {}
    import torch

    for rank, res in sorted(results.items()):
        res = _tensors_as(res, torch.from_numpy)
        errs[rank] = compare_linalg(res, want)
        bad = {k: e for k, e in errs[rank].items() if not e <= LINALG_2R_TOL}
        if bad:
            fail(f"rank {rank}: against world size 1 beyond {LINALG_2R_TOL}: {bad}")
        if res["mask_split"] != 0 or not bool((res["mask"] == want["mask"]).all()):
            fail(f"rank {rank}: the boolean mask at split 0: split {res['mask_split']}")
    print(json.dumps({"phase": "linalg_two_ranks", "note": "2 processes on ONE card over gloo, against world size 1",
                      "tol": LINALG_2R_TOL, "worst_rel_err": max(max(e.values()) for e in errs.values()),
                      "errs_rank0": errs[0], "mask_lshape": [results[r]["mask_lshape"] for r in (0, 1)],
                      "card": smi}), flush=True)


# ---------------------------------------------------------------------- #
# indexing (the array core's indexing surface; no kernel of its own)
# ---------------------------------------------------------------------- #
def _sectors(start: int, nbytes: int) -> int:
    """Bytes of the 32-byte sectors that a contiguous read of ``nbytes``
    bytes at byte ``start`` touches."""
    if nbytes <= 0:
        return 0
    return ((start + nbytes - 1) // SECTOR - start // SECTOR + 1) * SECTOR


def index_bytes(op: str, n: int, d: int, k: int = 0, nnz: int = 0, item: int = 4) -> tuple:
    """(bytes read, at 32-byte sectors; bytes written) of the phase's
    operation ``op`` on an (n, d) array of ``item``-byte elements (rows that
    start on a sector, as X's 128-byte and A's 64 KiB rows do): each input
    read once and each output written once, ``k`` rows picked by an int64
    index, ``nnz`` the True count of the operation's mask."""
    row, size = _sectors(0, d * item), d * item
    return {
        "X[idx]": (k * 8 + k * row, k * size),
        "X[::2]": (-(-n // 2) * row, -(-n // 2) * size),
        "X[::-1]": (n * row, n * size),
        "X[:, 3]": (n * _sectors(3 * item, item), n * item),
        "X[m]": (n + nnz * row, nnz * size),
        "X[m] = 0": (n, nnz * size),
        "X[idx] = Y": (k * 8 + k * row, k * size),
        "where(X > 0, X, 0)": (n * row, n * size),
        "nonzero(m)": (n, nnz * 4),
        "A[:, 100:200]": (n * _sectors(100 * item, 100 * item), n * 100 * item),
        "A[5]": (row, size),
        "A[:, ::2]": (n * row, n * (d // 2) * item),  # 8-byte stride: every sector of every row
        "A[A < 0] = 0": (n * row, nnz * item),
        "A.fill_diagonal(0)": (0, min(n, d) * item),
        "identity": (0, n * size),
        "tri": (0, n * size),
        "vander": (n * item, n * size),
    }[op]


def index_bound_ms(op: str, *args, **kwargs) -> float:
    """The least time of ``op``: its bytes (:func:`index_bytes`) at the
    card's memory rate."""
    read, write = index_bytes(op, *args, **kwargs)
    return (read + write) / PEAK_BYTES * 1e3


def d2h_bytes(fn) -> tuple:
    """(bytes the profiler saw copied from the card to the host during
    ``fn()``, the number of such copies): the ``bytes`` of each device-to-host
    memcpy in torch.profiler's trace."""
    import os
    import tempfile

    prof, _ = profiled(fn, "d2h_bytes", cpu=True)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]
    if any("bytes" not in e.get("args", {}) for e in copies):
        fail(f"a device-to-host copy in the trace names no bytes: {copies[:2]}")
    return sum(int(e["args"]["bytes"]) for e in copies), len(copies)


def _index_row(label: str, split, fn, want_fn, reps: int, bound_args: tuple, smi: str, **bound_kw) -> None:
    """Check one operation of the phase (``fn()``'s result on the card, bit
    for bit ``want_fn()``, torch's own indexing of the same tensor, of
    INDEX_SPLITS' split; both freed before the timing), time it
    (``cuda_ms``) and print it beside its bytes bound."""
    import torch

    key = f"{label} @ {split}"
    got, want = fn(), want_fn()
    if not got.larray.is_cuda:
        fail(f"indexing {key}: the result left the card ({got.larray.device})")
    if got.split != INDEX_SPLITS[key] or tuple(got.shape) != tuple(want.shape):
        fail(f"indexing {key}: split {got.split}, shape {got.shape}; the table says {INDEX_SPLITS[key]}, torch "
             f"{tuple(want.shape)}")
    if got.larray.dtype != want.dtype or not torch.equal(got.larray, want):
        fail(f"indexing {key}: differs from torch's own indexing")
    result_split, shape = got.split, list(got.shape)
    del got, want
    ms = cuda_ms(fn, reps)
    read, written = index_bytes(label, *bound_args, **bound_kw)
    bound = index_bound_ms(label, *bound_args, **bound_kw)
    print(json.dumps({"phase": "indexing", "op": label, "split": split, "result_split": result_split, "shape": shape,
                      "ms": ms, "bytes_read": read, "bytes_written": written, "bound_ms": bound,
                      "share_of_bound": bound / ms, "bitwise_equal_to_torch": True, "card": smi}), flush=True)


def indexing_world_one(ht, smi: str) -> None:
    """The indexing phase at world size 1: X = 1e8 x 32 float32 split 0 and
    A = 16384^2 float32 at split 0 and 1, every result held bit for bit
    against torch's own indexing of the same local tensor and its split
    against INDEX_SPLITS, timed beside its bytes bound; ``str(X)``'s wall
    time and the bytes it copies to the host."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n, d = N_MAIN, D
    ht.random.seed(13)
    X = ht.random.randn(n, d, split=0)
    xl = X.larray
    g = torch.Generator(device="cuda").manual_seed(13)
    idx = torch.randint(0, n, (INDEX_PICK,), generator=g, device="cuda")
    k = INDEX_PICK
    _index_row("X[idx]", 0, lambda: X[idx], lambda: xl[idx], 5, (n, d), smi, k=k)
    _index_row("X[::2]", 0, lambda: X[::2], lambda: xl[::2].clone(), 3, (n, d), smi)
    _index_row("X[::-1]", 0, lambda: X[::-1], lambda: xl.flip(0), 3, (n, d), smi)
    _index_row("X[:, 3]", 0, lambda: X[:, 3], lambda: xl[:, 3].clone(), 5, (n, d), smi)
    m = X[:, 0] > 0
    ml = xl[:, 0] > 0
    nnz = int(ml.sum())
    _index_row("X[m]", 0, lambda: X[m], lambda: xl[ml], 3, (n, d), smi, nnz=nnz)
    _index_row("where(X > 0, X, 0)", 0, lambda: ht.where(X > 0, X, 0), lambda: torch.where(xl > 0, xl, 0), 3,
               (n, d), smi)
    _index_row("nonzero(m)", 0, lambda: ht.nonzero(m), lambda: torch.nonzero(ml).reshape(-1).to(torch.int32), 3,
               (n, d), smi, nnz=nnz)
    t0 = time.perf_counter()
    text = str(X)
    str_s = time.perf_counter() - t0
    copied, copies = d2h_bytes(lambda: str(X))
    if "..." not in text or not 0 < copied <= STR_EDGE_BYTES:
        fail(f"str(X) copied {copied} bytes to the host in {copies} copies (at most {STR_EDGE_BYTES}: the edges)")
    print(json.dumps({"phase": "indexing", "op": "str(X)", "split": 0, "wall_ms": str_s * 1e3,
                      "device_to_host_bytes": copied, "device_to_host_copies": copies, "chars": len(text),
                      "card": smi}), flush=True)

    want = xl.clone()
    want[ml] = 0

    def masked_zero():
        X[m] = 0
        return X

    _index_row("X[m] = 0", 0, masked_zero, lambda: want, 3, (n, d), smi, nnz=nnz)
    pick = torch.randperm(n, generator=g, device="cuda")[:k]  # unique: one write a row
    Y = ht.array(torch.randn(k, d, generator=g, device="cuda"), split=0)
    want[pick] = Y.larray

    def rows_set():
        X[pick] = Y
        return X

    _index_row("X[idx] = Y", 0, rows_set, lambda: want, 3, (n, d), smi, k=k)
    del X, xl, want, m, ml, Y, pick, idx
    torch.cuda.empty_cache()

    na = INDEX_A
    for split in (0, 1):
        ht.random.seed(na + split)
        A = ht.random.randn(na, na, split=split)
        al = A.larray
        _index_row("A[:, 100:200]", split, lambda: A[:, 100:200], lambda: al[:, 100:200].clone(), 10, (na, na), smi)
        _index_row("A[5]", split, lambda: A[5], lambda: al[5].clone(), 10, (na, na), smi)
        _index_row("A[:, ::2]", split, lambda: A[:, ::2], lambda: al[:, ::2].clone(), 10, (na, na), smi)
        if split == 1:
            want = al.clone()
            neg = int((al < 0).sum())
            want[want < 0] = 0

            def clip():
                A[A < 0] = 0
                return A

            _index_row("A[A < 0] = 0", split, clip, lambda: want, 5, (na, na), smi, nnz=neg)
        want = A.larray.clone()
        want.fill_diagonal_(0)
        _index_row("A.fill_diagonal(0)", split, lambda: A.fill_diagonal(0), lambda: want, 10, (na, na), smi)
        del A, al, want
    v = torch.linspace(-1.0, 1.0, na, device="cuda")
    powers = torch.arange(na - 1, -1, -1, device="cuda", dtype=v.dtype)
    for label, fn, want_fn in (
            ("identity", lambda: ht.identity(na, split=0), lambda: torch.eye(na, device="cuda")),
            ("tri", lambda: ht.tri(na, split=0), lambda: torch.ones(na, na, device="cuda").tril()),
            ("vander", lambda: ht.vander(ht.array(v, split=0)), lambda: torch.pow(v[:, None], powers[None, :]))):
        _index_row(label, 0, fn, want_fn, 5, (na, na), smi)
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "indexing_world_one", "seconds": time.perf_counter() - t_phase,
                      "max_memory_allocated": torch.cuda.max_memory_allocated(), "card": smi}), flush=True)


def index_cases(ht) -> dict:
    """The two-rank phase's calls on the card, from arrays drawn on the card
    from one seed (INDEX_2R, with a -0.0): every key kind at each split
    (ints, slices of any step, Ellipsis, None, integer arrays as lists,
    numpy, tensors and split DNDarrays, broadcast index arrays, boolean
    masks over every run of axes), ``__setitem__`` with each value kind (a
    Python scalar, numpy, a tensor, a DNDarray at each split), ``where``,
    ``nonzero``, ``fill_diagonal`` and ``str``.  Each result gathered to the
    host as (value, shape, split)."""
    import numpy as np
    import torch

    g = torch.Generator(device="cuda").manual_seed(14)
    data = {name: torch.randn(*shape, generator=g, device="cuda") for name, (shape, _) in INDEX_2R.items()}
    data["rows"][3, 2] = -0.0
    out = {}

    def keep(name, x):
        if isinstance(x, str):
            out[name] = x
            return
        if not x.larray.is_cuda:
            fail(f"{name}: a result left the card ({x.larray.device})")
        out[name] = (x.numpy().copy(), list(x.shape), x.split)

    def flat(name, a):
        ha = data[name].cpu().numpy()
        mask = ha > 0
        return {
            "int": 3, "neg_int": -2, "slice": slice(2, 600), "step": slice(1, None, 3), "reversed": slice(None, None, -1),
            "neg_step": slice(-2, 0, -7), "ellipsis": Ellipsis, "none": None, "list": [len(ha) - 1, 0, 5, 5, -1],
            "numpy_2d": np.array([[0, 6], [1, 5]]), "tensor": torch.tensor([6, 0, 2], device="cuda"),
            "dndarray": ht.array(torch.tensor([6, 1, 6, 0], device="cuda"), split=0),
            "col": (slice(None), 2), "cols": (slice(None), [1, 2]), "pairs": ([1, 5], [3, 4]), "scalar": (5, 3),
            "broadcast": ([[0], [6]], [0, 2]), "int_cols": (3, [6, 0, 6]), "cols_reversed": (slice(None), slice(None, None, -2)),
            "both_reversed": (slice(None, None, -3), slice(5, 1, -1)), "mask": mask,
            "mask_dndarray": ht.array(data[name], split=a.split) > 0, "lead_mask": (mask[:, 0],),
            "tail_mask": (slice(None), mask[0]),
        }

    for name in ("rows", "cols"):
        for split in INDEX_2R[name][1]:
            x = ht.array(data[name], split=split)
            for key_name, key in flat(name, x).items():
                keep(f"{name}[{key_name}] @ {split}", x[key])
    cube = data["cube"]
    hc = cube.cpu().numpy()
    cube_keys = {"int_slice_cols": (1, slice(None), [0, 4]), "slice_int_cols": (slice(None), 0, [1, 2]),
                 "arrays_around_slice": ([0, 12], slice(None), [2, 3]), "mask_lead_two": (hc[:, :, 0] > 0,),
                 "mask_tail_two": (slice(None), hc[0] > 0), "mask_middle": (slice(None), hc[0, :, 0] > 0, slice(1, 3)),
                 "ellipsis_array_none": (Ellipsis, [1, 2], None), "int_array_reversed": (0, [1, 2], slice(None, None, -1)),
                 "reversed": slice(None, None, -1), "none_ellipsis": (None, Ellipsis, 2)}
    for split in INDEX_2R["cube"][1]:
        x = ht.array(cube, split=split)
        for key_name, key in cube_keys.items():
            keep(f"cube[{key_name}] @ {split}", x[key])
        values = {"python": 2.5, "numpy": np.arange(12, dtype=np.float32).reshape(2, 6),
                  "tensor": torch.arange(12, device="cuda", dtype=torch.float32).reshape(2, 6)}
        values.update({f"dndarray_{vs}": ht.array(values["tensor"], split=vs) for vs in (None, 0, 1)})
        for vname, v in values.items():
            y = ht.array(cube, split=split)
            y[1, :, [0, 4]] = v
            keep(f"cube[1, :, [0, 4]] = {vname} @ {split}", y)
        for vs in (None, 0, 1):
            y = ht.array(cube, split=split)
            y[::-1, 2] = ht.array(torch.arange(65, device="cuda", dtype=torch.float32).reshape(13, 5), split=vs)
            keep(f"cube[::-1, 2] = dndarray_{vs} @ {split}", y)
        y = ht.array(cube, split=split)
        nsel = int((cube[:, :, 0] > 0).sum())
        y[hc[:, :, 0] > 0] = ht.array(-torch.arange(nsel * 5, device="cuda", dtype=torch.float32).reshape(nsel, 5),
                                      split=0)
        keep(f"cube[mask] = rows @ {split}", y)
        y = ht.array(cube, split=split)
        y[ht.array(cube, split=split) < 0] = 0
        keep(f"cube[cube < 0] = 0 @ {split}", y)
        keep(f"where @ {split}", ht.where(x > 0, x, 0))
        keep(f"nonzero @ {split}", ht.nonzero(x > 0))
        keep(f"fill_diagonal @ {split}", ht.array(cube, split=split).fill_diagonal(-1.0))
        keep(f"str @ {split}", str(x))
    for name in ("rows", "cols"):
        for split in INDEX_2R[name][1]:
            x = ht.array(data[name], split=split)
            x[[5, x.shape[0] - 1, 3]] = np.full((3, x.shape[1]), 7.0, np.float32)
            keep(f"{name}[list] = numpy @ {split}", x)
            x[x > 1] = ht.array(torch.zeros(int((x.larray > 1).sum()), device="cuda"), is_split=0)
            keep(f"{name}[mask] = split values @ {split}", x)
            keep(f"{name} fill_diagonal @ {split}", x.fill_diagonal(9.0))
            keep(f"{name} str @ {split}", str(x))
    return out


def index_put_at_size(ht) -> list:
    """On this rank of 2: ``X[pick] = Y`` and ``X[::-1] = c`` at the phase's
    sizes (X = 1e8 x 32 float32 split 0; Y = INDEX_PICK unique rows split 0;
    c an (n, 1) column, the same on every rank), each checked bit for bit on
    this rank's rows against torch's own assignment of the same values and
    timed three times (wall, between barriers).  For ``X[pick] = Y``, the
    bytes this rank sent beside the bytes the design needs: each row of its
    block of Y that another rank holds, with its int64 position."""
    import torch
    import torch.distributed as dist

    comm = ht.core.communication.get_comm()
    n, d, k = N_MAIN, D, INDEX_PICK
    ht.random.seed(13)
    X = ht.random.randn(n, d, split=0)
    counts, displs = X.counts_displs()
    lo, hi = displs[comm.rank], displs[comm.rank] + counts[comm.rank]
    g = torch.Generator(device="cuda").manual_seed(17)
    pick = torch.randperm(n, generator=g, device="cuda")[:k]
    y = torch.randn(k, d, generator=g, device="cuda")
    Y = ht.array(y, split=0)
    ycounts, ydispls = Y.counts_displs()
    mine = pick[ydispls[comm.rank] : ydispls[comm.rank] + ycounts[comm.rank]]
    moved = int(((mine < lo) | (mine >= hi)).sum())
    out = []

    def timed(label, fn, want, **extra):
        comm.reset_traffic()
        ms = []
        for rep in range(3):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            dist.barrier()
            ms.append((time.perf_counter() - t0) * 1e3)
            if rep == 0:
                sent = comm.traffic()
        if not torch.equal(X.larray, want):
            fail(f"rank {comm.rank}: {label} on 2 ranks differs from torch's own assignment")
        out.append({"op": label, "wall_ms": ms, "traffic": sent, **extra})

    want = X.larray.clone()
    own = (pick >= lo) & (pick < hi)
    want[pick[own] - lo] = y[own]

    def rows_set():
        X[pick] = Y

    timed("X[idx] = Y", rows_set, want, alltoall_bytes_needed=moved * (8 + d * 4))
    del want
    col = torch.arange(n, device="cuda", dtype=torch.float32).reshape(n, 1)
    want = col.flip(0)[lo:hi].expand(hi - lo, d).contiguous()

    def run_set():
        X[::-1] = col

    timed("X[::-1] = column", run_set, want)
    for row in out:
        sent = row["traffic"].get("Alltoall", {}).get("bytes", 0)
        if "alltoall_bytes_needed" in row and sent != row["alltoall_bytes_needed"]:
            fail(f"rank {comm.rank}: {row['op']} sent {sent} bytes; the rows that change rank need "
                 f"{row['alltoall_bytes_needed']}")
    del X, want, col, Y, y, pick
    torch.cuda.empty_cache()
    return out


def index_rank(ht, rank: int) -> dict:
    """A rank's part of ``two_rank_world``: ``index_cases``, reported with
    the communicator's traffic."""
    comm = ht.core.communication.get_comm()
    comm.reset_traffic()
    res = index_cases(ht)
    res["_traffic"] = comm.traffic()
    res["_at_size"] = index_put_at_size(ht)
    return res


def indexing_two_ranks(ht, smi: str, results: dict, part_s: float) -> None:
    """The two-rank indexing phase: ``index_cases`` at world size 1 on this
    card against what ``index_rank`` gave in 2 processes on this card over
    gloo (``results``, part of ``two_rank_world``, which took ``part_s``
    seconds on rank 0); every result of every rank exactly world size 1's
    (values with the sign of zero, gshape, split); prints rank 0's line."""
    import numpy as np

    t0 = time.perf_counter()
    want = index_cases(ht)
    for rank, res in sorted(results.items()):
        for row in res["_at_size"]:
            print(json.dumps({"phase": "indexing_two_ranks", "rank": rank, **row, "card": smi}), flush=True)
        for name, w in want.items():
            got = res.get(name)
            if isinstance(w, str):
                if got != w:
                    fail(f"rank {rank}: {name} differs from world size 1:\n{got}\n{w}")
                continue
            same = (got is not None and got[1:] == w[1:] and got[0].dtype == w[0].dtype
                    and np.array_equal(got[0], w[0], equal_nan=True)
                    and (w[0].dtype.kind != "f" or np.array_equal(np.signbit(got[0]), np.signbit(w[0]))))
            if not same:
                fail(f"rank {rank}: {name} differs from world size 1: {None if got is None else got[1:]} vs {w[1:]}")
    print(json.dumps({"phase": "indexing_two_ranks", "note": "2 processes on ONE card over gloo, against world size 1",
                      "cases": len(want), "exact": True, "traffic_rank0": results[0]["_traffic"],
                      "seconds": part_s + time.perf_counter() - t0, "card": smi}), flush=True)


# ---------------------------------------------------------------------- #
# 3c/3d: the random streams, statistics, manipulations and the sort
# ---------------------------------------------------------------------- #
def stats_bound_ms(read: float, written: float, flops: float = 0.0) -> tuple:
    """(least time, what bounds it): the bytes read once and written once
    at the card's memory rate, or the float32 operations at its CUDA-core
    peak, the larger."""
    by_bytes = (read + written) / PEAK_BYTES * 1e3
    by_ops = flops / PEAK_FP32 * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _max_err64(got, want64) -> float:
    """max |got - want64| over max |want64| (float64 on the card)."""
    import torch

    g = got.double()
    scale = float(want64.abs().max()) or 1.0
    return float((g - want64).abs().max()) / scale


def once_ms(fn) -> tuple:
    """(``fn()``, ms of that one call between two CUDA events): for calls
    that take seconds, where one call is the measurement."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _stats_row(label: str, got, smi: str, fn, reps: int, read: float, written: float, flops: float = 0.0,
               check: str = "", err=None, torch_fn=None, ms=None) -> dict:
    """Check ``got``'s place (a CUDA tensor, STATS_SPLITS' split), time ``fn``
    (``cuda_ms``; or take ``ms``, one call's) and ``torch_fn`` (torch's own
    call, where there is one), and print the row beside the bound."""
    if got is not None:
        for part in (got if isinstance(got, (tuple, list)) else (got,)):
            if not part.larray.is_cuda:
                fail(f"{label}: a result left the card ({part.larray.device})")
        first = got[0] if isinstance(got, (tuple, list)) else got
        if first.split != STATS_SPLITS[label]:
            fail(f"{label}: split {first.split}, the reference's is {STATS_SPLITS[label]}")
    ms = cuda_ms(fn, reps) if ms is None else ms
    bound, by = stats_bound_ms(read, written, flops)
    row = {"phase": "statistics", "op": label, "split": STATS_SPLITS[label], "ms": ms, "bound_ms": bound,
           "bound_by": by, "share_of_bound": bound / ms, "check": check, "max_rel_err_vs_float64": err,
           "torch_ms": cuda_ms(torch_fn, reps) if torch_fn is not None else None, "card": smi}
    print(json.dumps(row), flush=True)
    return row


def _chunked64(t, fn, rows: int = 1 << 23):
    """``fn`` summed over float64 row blocks of ``t`` (a float64 reduction
    that never holds all of ``t`` in float64)."""
    acc = None
    for s in range(0, t.shape[0], rows):
        part = fn(t[s:s + rows].double())
        acc = part if acc is None else acc + part
    return acc


def stats_world_one(ht, smi: str) -> None:
    """Phase 3c: the random streams, the reductions, the order ops, the
    reshapes and the contractions at world size 1, at the sizes users run
    them: X = rand(1e8, 32) (config 2's rows), v = rand(1e9), w =
    randint(0, 1e6, 1e9), A = config 0's 16384^2 operand, M = 4096^2.  Each
    result on the card, of STATS_SPLITS' split, bit for bit torch's own call
    where the port's path is that call, else held against float64 on the
    card (within STATS_RTOL of the largest entry); timed beside its bound."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n, d = N_MAIN, D
    xbytes = n * d * 4

    # the draws: each value a function of (seed, counter, flat index)
    ht.random.seed(STATS_SEED)
    X, rand_ms = once_ms(lambda: ht.random.rand(n, d, split=0))
    Xn, randn_ms = once_ms(lambda: ht.random.randn(n, d, split=0))
    Xi, randint_ms = once_ms(lambda: ht.random.randint(0, 1000, (n, d), split=0))
    prefix = STATS_PREFIX // d
    ht.random.seed(STATS_SEED)
    cpu = [ht.random.rand(prefix, d, split=0, device="cpu"), ht.random.randn(prefix, d, split=0, device="cpu"),
           ht.random.randint(0, 1000, (prefix, d), split=0, device="cpu")]
    for label, got, want in (("rand", X, cpu[0]), ("randn", Xn, cpu[1]), ("randint", Xi, cpu[2])):
        head = got.larray[:prefix].cpu()
        if label == "randn":  # erfinv on the card and on the host may round apart
            err = float((head.double() - want.larray.double()).abs().max())
            if err > 1e-6:
                fail(f"randn's first {STATS_PREFIX} values on the card differ from the CPU path's by {err}")
            check = f"first {STATS_PREFIX} values within 1e-6 of the CPU path's"
        else:
            if not torch.equal(head, want.larray):
                fail(f"{label}'s first {STATS_PREFIX} values on the card differ from the CPU path's")
            err, check = 0.0, f"first {STATS_PREFIX} values bit for bit the CPU path's"
        ms = {"rand": rand_ms, "randn": randn_ms, "randint": randint_ms}[label]
        _stats_row(label, got, smi, None, 1, 0, xbytes, check=check, err=err, ms=ms,
                   torch_fn={"rand": lambda: torch.rand(n, d, device="cuda"),
                             "randn": lambda: torch.randn(n, d, device="cuda"),
                             "randint": lambda: torch.randint(0, 1000, (n, d), device="cuda", dtype=torch.int32)}[label])
    if float(X.larray.min()) < 0 or float(X.larray.max()) >= 1:
        fail("rand left [0, 1)")
    del Xn, Xi, cpu
    torch.cuda.empty_cache()

    # reductions of X along 0, 1 and None
    xl = X.larray
    mu64 = _chunked64(xl, lambda b: b.sum(0)) / n
    var64 = _chunked64(xl, lambda b: ((b - mu64) ** 2).sum(0)) / n
    tot64 = mu64.mean()
    var_all64 = _chunked64(xl, lambda b: ((b - tot64) ** 2).sum()) / (n * d)
    for op, axis in (("mean", 0), ("mean", 1), ("mean", None), ("var", 0), ("var", 1), ("var", None),
                     ("std", 0), ("std", 1), ("std", None)):
        label = f"{op}(X, {axis})" if axis is not None else f"{op}(X)"
        fn = (lambda op=op, axis=axis: getattr(ht, op)(X, axis))
        got = fn()
        if axis == 0:
            want = {"mean": mu64, "var": var64, "std": var64.sqrt()}[op]
        elif axis is None:
            want = {"mean": tot64, "var": var_all64, "std": var_all64.sqrt()}[op]
        else:
            want = None
        if want is not None:
            err = _max_err64(got.larray, want)
        else:  # along 1: 1e8 rows of 32, row blocks in float64
            err = 0.0
            for s in range(0, n, 1 << 23):
                b = xl[s:s + (1 << 23)].double()
                m = b.mean(1)
                w = {"mean": m, "var": ((b - m[:, None]) ** 2).mean(1), "std": ((b - m[:, None]) ** 2).mean(1).sqrt()}[op]
                err = max(err, _max_err64(got.larray[s:s + (1 << 23)], w))
        if err > STATS_RTOL:
            fail(f"{label}: {err} from float64")
        written = got.larray.numel() * 4
        kw = {} if op == "mean" else {"correction": 0}
        _stats_row(label, got, smi, fn, 3, xbytes, written, check="float64 on the card", err=err,
                   torch_fn=(lambda op=op, axis=axis, kw=kw: getattr(torch, op)(xl, axis, **kw) if axis is not None
                             else getattr(torch, op)(xl, **kw)))
        del got
    for axis in (0, 1, None):
        label = f"argmax(X, {axis})" if axis is not None else "argmax(X)"
        fn = (lambda axis=axis: ht.argmax(X, axis))
        got = fn()
        want = torch.argmax(xl, axis) if axis is not None else torch.argmax(xl)
        if not torch.equal(got.larray.to(torch.int64), want):
            fail(f"{label}: differs from torch.argmax")
        _stats_row(label, got, smi, fn, 3, xbytes, want.numel() * 4, check="bit for bit torch.argmax",
                   torch_fn=(lambda axis=axis: torch.argmax(xl, axis) if axis is not None else torch.argmax(xl)))
        del got, want
    got = ht.cov(X, rowvar=False)
    c64 = _chunked64(xl, lambda b: (b - mu64).T @ (b - mu64)) / (n - 1)
    err = _max_err64(got.larray, c64)
    if err > STATS_RTOL:
        fail(f"cov: {err} from float64")
    _stats_row("cov(X, rowvar=False)", got, smi, lambda: ht.cov(X, rowvar=False), 2, xbytes, d * d * 4,
               flops=2.0 * n * d * d, check="float64 on the card", err=err,
               torch_fn=lambda: torch.cov(xl.T))
    col = X[:, 0]
    h, e = ht.histogram(col, 100)
    cl = col.larray.double()
    e64 = e.larray.double()
    idx = torch.searchsorted(e64, cl, right=True)
    idx = torch.where(cl == e64[-1], torch.full_like(idx, 100), idx)
    want = torch.bincount(idx[(idx >= 1) & (idx <= 100)] - 1, minlength=100)
    if not torch.equal(h.larray.to(torch.int64), want):
        fail("histogram(X[:, 0], 100): counts differ from float64 binning on the same edges")
    if int(h.larray.sum()) != n:
        fail("histogram(X[:, 0], 100) lost elements")
    _stats_row("histogram(X[:, 0], 100)", h, smi, lambda: ht.histogram(col, 100), 3, n * SECTOR, 100 * 4,
               check="exact against float64 binning on its edges", err=0.0,
               torch_fn=lambda: torch.histc(col.larray, 100))
    del h, e, cl, e64, idx, want, col, c64, got
    torch.cuda.empty_cache()

    # reshapes and movement of X
    for label, fn, want_fn in (
            ("reshape(X, (5e7, 64))", lambda: ht.reshape(X, (n // 2, 2 * d)), lambda: xl.reshape(n // 2, 2 * d)),
            ("concatenate(X halves)", lambda: ht.concatenate([X[: n // 2], X[n // 2:]]), lambda: xl),
            ("roll(X, 1000, 0)", lambda: ht.roll(X, 1000, 0), lambda: torch.roll(xl, 1000, 0))):
        got = fn()
        if not torch.equal(got.larray, want_fn()):
            fail(f"{label}: differs from torch's own")
        _stats_row(label, got, smi, fn, 2, xbytes, xbytes, check="bit for bit torch's own")
        del got
        torch.cuda.empty_cache()
    got = ht.einsum("ij,ik->jk", X, X)
    g64 = _chunked64(xl, lambda b: b.T @ b)
    err = _max_err64(got.larray, g64)
    if err > STATS_RTOL:
        fail(f"einsum('ij,ik->jk', X, X): {err} from float64")
    _stats_row("einsum('ij,ik->jk', X, X)", got, smi, lambda: ht.einsum("ij,ik->jk", X, X), 3, xbytes, d * d * 4,
               flops=2.0 * n * d * d, check="float64 on the card", err=err, torch_fn=lambda: xl.T @ xl)
    del got, g64, X, xl
    torch.cuda.empty_cache()

    # v = rand(1e9): sort, percentiles, topk, searchsorted
    nv = STATS_V
    v = ht.random.rand(nv, split=0)
    vl = v.larray
    got_v, got_i = ht.sort(v)
    want_v, want_i = torch.sort(vl, stable=True)
    if not (torch.equal(got_v.larray, want_v) and torch.equal(got_i.larray.to(torch.int64), want_i)):
        fail("sort(v): differs from torch.sort(stable=True)")
    del want_i
    _stats_row("sort(v)", (got_v, got_i), smi, lambda: ht.sort(v), 1, nv * 4, nv * 8,
               check="bit for bit torch.sort(stable=True)", torch_fn=lambda: torch.sort(vl, stable=True))
    del got_i
    torch.cuda.empty_cache()
    got = ht.argsort(v)
    if not torch.equal(got.larray.to(torch.int64), torch.argsort(vl, stable=True)):
        fail("argsort(v): differs from torch.argsort(stable=True)")
    _stats_row("argsort(v)", got, smi, lambda: ht.argsort(v), 1, nv * 4, nv * 4,
               check="bit for bit torch.argsort(stable=True)", torch_fn=lambda: torch.argsort(vl, stable=True))
    del got
    torch.cuda.empty_cache()
    s64 = want_v  # the sorted values: the exact order statistics
    qs = torch.tensor([5.0, 50.0, 95.0], dtype=torch.float64, device="cuda") / 100
    pos = qs * (nv - 1)
    lo, hi = pos.floor().long(), pos.ceil().long()
    p64 = s64[lo].double() * (1 - (pos - lo)) + s64[hi].double() * (pos - lo)
    got = ht.percentile(v, [5, 50, 95])
    err = _max_err64(got.larray, p64)
    if err > STATS_RTOL:
        fail(f"percentile(v, [5, 50, 95]): {err} from the float64 order statistics")
    _stats_row("percentile(v, [5, 50, 95])", got, smi, lambda: ht.percentile(v, [5, 50, 95]), 1, nv * 4, 12,
               check="float64 of the exact order statistics", err=err)
    mpos = 0.5 * (nv - 1)
    m64 = (s64[int(mpos)].double() + s64[int(mpos) + 1].double()) / 2
    got = ht.median(v)
    err = _max_err64(got.larray.reshape(1), m64.reshape(1))
    if err > STATS_RTOL:
        fail(f"median(v): {err} from the float64 order statistics")
    _stats_row("median(v)", got, smi, lambda: ht.median(v), 1, nv * 4, 4, check="float64 of the exact order "
               "statistics", err=err)
    del s64, want_v, got
    torch.cuda.empty_cache()
    tv, ti = ht.topk(v, STATS_TOPK)
    ref = torch.topk(vl, STATS_TOPK).values
    picked = vl[ti.larray.long()]
    runs = (tv.larray[1:] == tv.larray[:-1])
    if not (torch.equal(tv.larray, ref) and torch.equal(picked, tv.larray)
            and bool((ti.larray[1:][runs] > ti.larray[:-1][runs]).all())
            and int((vl > tv.larray[-1]).sum()) == int((tv.larray > tv.larray[-1]).sum())):
        fail("topk(v, 1000): values differ from torch.topk's, or the indices are not the lowest of the ties")
    _stats_row("topk(v, 1000)", (tv, ti), smi, lambda: ht.topk(v, STATS_TOPK), 3, nv * 4, STATS_TOPK * 8,
               check="values bit for bit torch.topk; ties by lowest index", torch_fn=lambda: torch.topk(vl, STATS_TOPK))
    del tv, ti, ref, picked, runs
    sv = ht.sort(v)[0]
    q = ht.random.rand(STATS_QUERIES)
    got = ht.searchsorted(sv, q)
    if not torch.equal(got.larray.to(torch.int64), torch.searchsorted(sv.larray, q.larray)):
        fail("searchsorted: differs from torch.searchsorted")
    probes = STATS_QUERIES * int(np.ceil(np.log2(nv))) * SECTOR
    _stats_row("searchsorted(v, q)", got, smi, lambda: ht.searchsorted(sv, q), 5, probes + STATS_QUERIES * 4,
               STATS_QUERIES * 4, check="bit for bit torch.searchsorted",
               torch_fn=lambda: torch.searchsorted(sv.larray, q.larray))
    del sv, q, got, v, vl
    torch.cuda.empty_cache()
    w = ht.random.randint(0, STATS_UNIQUE_HIGH, (nv,), split=0)
    got = ht.unique(w)
    want = torch.unique(w.larray)
    if not torch.equal(got.larray, want):
        fail("unique(w): differs from torch.unique")
    _stats_row("unique(w)", got, smi, lambda: ht.unique(w), 1, nv * 4, want.numel() * 4,
               check="bit for bit torch.unique", torch_fn=lambda: torch.unique(w.larray))
    del w, got, want
    torch.cuda.empty_cache()

    # config 0's operand and the small factorizations
    na = INDEX_A
    A = ht.random.rand(na, na, split=0)
    got = ht.pad(A, STATS_PAD)
    if not torch.equal(got.larray, torch.nn.functional.pad(A.larray, (STATS_PAD,) * 4)):
        fail("pad(A, 8): differs from torch's pad")
    out_bytes = (na + 2 * STATS_PAD) ** 2 * 4
    _stats_row("pad(A, 8)", got, smi, lambda: ht.pad(A, STATS_PAD), 3, na * na * 4, out_bytes,
               check="bit for bit torch.nn.functional.pad",
               torch_fn=lambda: torch.nn.functional.pad(A.larray, (STATS_PAD,) * 4))
    del got, A
    torch.cuda.empty_cache()
    a = ht.random.rand(128, 128, split=0)
    b = ht.random.rand(128, 128)
    got = ht.kron(a, b)
    if not torch.equal(got.larray, torch.kron(a.larray, b.larray)):
        fail("kron: differs from torch.kron")
    _stats_row("kron(a, b)", got, smi, lambda: ht.kron(a, b), 5, 2 * 128 * 128 * 4, na * na * 4,
               check="bit for bit torch.kron", torch_fn=lambda: torch.kron(a.larray, b.larray))
    del got
    torch.cuda.empty_cache()
    nm = SOLVE_N
    g = torch.Generator(device="cuda").manual_seed(STATS_SEED)
    m = torch.eye(nm, device="cuda") + torch.randn(nm, nm, generator=g, device="cuda") * (0.01 / nm ** 0.5)
    M = ht.array(m, split=0)
    for label, fn, torch_fn, flops in (("det(M)", lambda: ht.linalg.det(M), lambda: torch.linalg.det(m),
                                        2.0 / 3 * nm ** 3),
                                       ("inv(M)", lambda: ht.linalg.inv(M), lambda: torch.linalg.inv(m), 2.0 * nm ** 3)):
        got, want = fn(), torch_fn()
        if not torch.equal(got.larray, want):
            fail(f"{label}: differs from torch.linalg's")
        _stats_row(label, got, smi, fn, 3, nm * nm * 4, want.numel() * 4, flops=flops,
                   check="bit for bit torch.linalg", torch_fn=torch_fn)
        del got
    del M, m
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "statistics_world_one", "seconds": time.perf_counter() - t_phase,
                      "max_memory_allocated": torch.cuda.max_memory_allocated(), "card": smi}), flush=True)


def stats_cases(ht, n_sort: int) -> dict:
    """Phase 3d's calls on the card, on the ragged shapes of
    tests/test_torch_sort_mp.py (23 elements, 10 x 7 rows, 7 x 6 x 5) drawn
    from one seed, at every split; and the sort of ``n_sort`` uniform draws.
    Each result gathered to the host as (value, shape, split, exact)."""
    import numpy as np

    ht.random.seed(STATS_SEED + 1)
    v = ht.random.randn(23).numpy()
    v[[2, 15]] = np.nan
    v[[5, 20]] = v[7]
    a = ht.random.randn(10, 7).numpy()
    ai = ht.random.randint(-4, 4, (10, 7)).numpy()
    t = ht.random.randn(7, 6, 5).numpy()
    i = ht.random.randint(0, 5, (23,)).numpy()
    out = {}

    def keep(name, r, exact=True):
        for k, part in enumerate(r if isinstance(r, (list, tuple)) else [r]):
            if not part.larray.is_cuda:
                fail(f"{name}: a result left the card ({part.larray.device})")
            out[f"{name}#{k}"] = (part.numpy().copy(), list(part.shape), part.split, exact)

    for s in (None, 0):
        x = ht.array(v, split=s)
        keep(f"sort_{s}", [*ht.sort(x), *ht.sort(x, descending=True), ht.argsort(x)])
        keep(f"unique_{s}", [*ht.unique(ht.array(i, split=s), return_inverse=True), *ht.unique_all(ht.array(i, split=s))])
        keep(f"order_stats_{s}", [ht.percentile(x, [0, 5, 50, 95, 100], interpolation=m) for m in
                                  ("lower", "higher", "nearest")] + [ht.argmax(x), ht.nanargmin(x)])
        keep(f"percentile_{s}", [ht.percentile(x, [5, 50, 95]), ht.nanmedian(x), ht.median(ht.array(a[:, 0], split=s))],
             exact=False)
        keep(f"topk_{s}", [*ht.topk(ht.array(a[:, 1], split=s), 3), *ht.topk(ht.array(np.sort(a[:, 2]), split=s), 4)])
        keep(f"searchsorted_{s}", ht.searchsorted(ht.array(np.sort(a[:, 3]), split=s), ht.array(a[:, 4])))
    for s in (None, 0, 1):
        x = ht.array(a, split=s)
        keep(f"manip_{s}", [ht.reshape(x, (7, 10)), ht.concatenate([x, x]), ht.concatenate([x, x], 1),
                            ht.roll(x, 3, 0), ht.roll(x, -2, 1), ht.pad(x, ((3, 1), (0, 2))), ht.flip(x, 0),
                            ht.sort(x, 0)[0], ht.repeat(x, 2, 0), ht.tile(x, (2, 1)), ht.diagonal(x)])
        keep(f"reduce_{s}", [ht.mean(x, 0), ht.var(x, 1), ht.std(x), ht.cov(x), ht.einsum("ij,ik->jk", x, x),
                             ht.skew(x, 0), ht.kurtosis(x, 1)], exact=False)
        keep(f"argmax_{s}", [ht.argmax(ht.array(ai, split=s), 0), ht.argmin(ht.array(ai, split=s)),
                             *ht.histogram(x, 5)[:1], ht.bincount(ht.array(i))])
    for s in (None, 0, 1, 2):
        x = ht.array(t, split=s)
        keep(f"cube_{s}", [ht.reshape(x, (42, 5)), ht.reshape(x, (6, 35)), ht.flatten(x), ht.swapaxes(x, 0, 2),
                           ht.squeeze(x[:, :1]), ht.expand_dims(x, 1)])
    for s in (None, 0, 1):
        ht.random.seed(STATS_SEED + 2)
        keep(f"draws_{s}", [ht.random.rand(10, 7, split=s), ht.random.randint(0, 50, (10, 7), split=s)])
        keep(f"draws_normal_{s}", [ht.random.randn(10, 7, split=s)], exact=False)
    ht.random.seed(STATS_SEED + 3)
    big = ht.random.rand(n_sort, split=0)
    sv, si = ht.sort(big)
    out["big_sort_values"] = (sv.numpy()[::STATS_2R_STRIDE].copy(), [n_sort], 0, True)
    out["big_sort_indices"] = (si.numpy()[::STATS_2R_STRIDE].copy(), [n_sort], 0, True)
    out["big_sort_sorted"] = bool(ht.all(sv[1:] >= sv[:-1]))
    return out


def stats_rank(ht, rank: int, n_sort: int) -> dict:
    """A rank's part of ``two_rank_world``: ``stats_cases`` and the sort's
    Alltoall bytes."""
    import torch

    comm = ht.core.communication.get_comm()
    res = stats_cases(ht, n_sort)
    ht.random.seed(STATS_SEED + 3)
    big = ht.random.rand(n_sort, split=0)
    comm.reset_traffic()
    t0 = time.perf_counter()
    ht.sort(big)
    torch.cuda.synchronize()
    res["_sort"] = {"traffic": comm.traffic(), "seconds": time.perf_counter() - t0, "lshape": big.lshape[0]}
    return res


def stats_two_ranks(ht, smi: str, results: dict, part_s: float) -> None:
    """Phase 3d: ``stats_cases`` at world size 1 on this card against
    ``stats_rank``'s in 2 processes on this card over gloo (``results``,
    ``part_s`` seconds on rank 0); each result of each rank world size 1's
    (exact, or within STATS_2R_RTOL for the float reductions); prints each
    rank's Alltoall bytes of the 1e7-element sort."""
    import numpy as np

    t0 = time.perf_counter()
    want = stats_cases(ht, STATS_2R_SORT)
    for rank, res in sorted(results.items()):
        for name, w in want.items():
            got = res.get(name)
            if name == "big_sort_sorted":
                if not got:
                    fail(f"rank {rank}: the 1e7 sort is not sorted")
                continue
            exact = w[3]
            same = got is not None and got[1:3] == w[1:3] and got[0].dtype == w[0].dtype and (
                np.array_equal(got[0], w[0], equal_nan=True) if exact else
                np.allclose(got[0], w[0], rtol=STATS_2R_RTOL, atol=1e-6, equal_nan=True))
            if not same:
                fail(f"rank {rank}: {name} differs from world size 1: {None if got is None else got[1:3]} vs {w[1:3]}")
        s = res["_sort"]
        sent = s["traffic"].get("Alltoall", {}).get("bytes", 0)
        if sent > s["lshape"] * (4 + 8):
            fail(f"rank {rank}: the sort sent {sent} Alltoall bytes, past its chunk's values and indices")
        print(json.dumps({"phase": "statistics_two_ranks", "rank": rank, "op": f"sort(rand({STATS_2R_SORT}))",
                          "alltoall_bytes": sent, "chunk_bytes": s["lshape"] * 4, "traffic": s["traffic"],
                          "seconds": s["seconds"], "card": smi}), flush=True)
    print(json.dumps({"phase": "statistics_two_ranks", "note": "2 processes on ONE card over gloo, against world "
                      "size 1", "cases": len(want), "seconds": part_s + time.perf_counter() - t0, "card": smi}),
          flush=True)


# ---------------------------------------------------------------------- #
# data-parallel training (BASELINE configs 3 and 4)
# ---------------------------------------------------------------------- #
def mnist_synthetic(n: int, seed: int):
    """MNIST-shaped data made on the card from a seeded generator: (n, 28,
    28) float32 images in [0, 1] whose class k is a Gaussian bump where
    ``heat_tpu/utils/data/mnist.py::_synthetic`` puts it, plus noise 0.05,
    and (n,) int32 labels."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    labels = torch.randint(0, 10, (n,), generator=g, device="cuda")
    grid = torch.arange(28.0, device="cuda")
    cx, cy = 4 + 2.2 * (labels % 5).float(), 7 + 11 * (labels // 5).float()
    imgs = torch.exp(-((grid[None, None, :] - cx[:, None, None]) ** 2 + (grid[None, :, None] - cy[:, None, None]) ** 2)
                     / 14.0)
    imgs += 0.05 * torch.randn(imgs.shape, generator=g, device="cuda")
    return imgs.clamp_(0.0, 1.0), labels.to(torch.int32)


def mnist_model(ht):
    """``examples/nn_mnist_demo.py``'s model: Flatten, 784-128-64-10 with ReLU."""
    return ht.nn.Sequential(ht.nn.Flatten(), ht.nn.Linear(784, 128), ht.nn.ReLU(), ht.nn.Linear(128, 64),
                            ht.nn.ReLU(), ht.nn.Linear(64, 10))


def max_rel_err(got: dict, want: dict) -> tuple:
    """(name, max |got - want| / max |want|) of the worst of two state dicts."""
    return max(((n, float((got[n].double() - w.double()).abs().max() / w.double().abs().max().clamp_min(1e-30)))
                for n, w in want.items()), key=lambda t: t[1])


def _plain_step(model, opt, x, y, loss_fn):
    opt.zero_grad()
    loss = loss_fn(model(x), y)
    loss.backward()
    opt.step()
    return loss.detach()


def config3_world_one(ht, smi: str) -> None:
    """BASELINE config 3 at world size 1: the MLP on 60000 MNIST-shaped
    rows, Adam, DataLoader(batch_size=256, shuffle=True), 3 epochs; the
    loss falls and train accuracy passes MNIST_ACC; one make_train_step step
    is one plain torch step, bit for bit."""
    import copy

    import torch

    ce = ht.nn.functional.cross_entropy
    x, y = mnist_synthetic(MNIST_N, 3)
    torch.manual_seed(0)
    model = mnist_model(ht)
    plain = copy.deepcopy(model)
    dp = ht.nn.DataParallel(model, optimizer=ht.optim.DataParallelOptimizer("adam", lr=MNIST_LR))
    step = dp.make_train_step(ce)
    popt = torch.optim.Adam(plain.parameters(), lr=MNIST_LR)
    for b in range(2):
        rows = slice(b * MNIST_BATCH, (b + 1) * MNIST_BATCH)
        loss, loss_plain = step(x[rows], y[rows]), _plain_step(plain, popt, x[rows], y[rows], ce)
        same = torch.equal(loss, loss_plain) and all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                                                      plain.parameters()))
        if not same:
            fail(f"config 3: a DataParallel step at world size 1 is not the plain torch step's bits (step {b + 1})")
    torch.manual_seed(0)
    model = mnist_model(ht)
    dp = ht.nn.DataParallel(model, optimizer=ht.optim.DataParallelOptimizer("adam", lr=MNIST_LR))
    step = dp.make_train_step(ce)
    loader = ht.utils.data.DataLoader(ht.utils.data.Dataset(ht.array(x, split=0), labels=ht.array(y, split=0)),
                                      batch_size=MNIST_BATCH, shuffle=True)
    torch.cuda.synchronize()
    losses, step_s, epoch_s = [], [], []
    for _ in range(MNIST_EPOCHS):
        t_epoch = time.perf_counter()
        for xb, yb in loader:
            t0 = time.perf_counter()
            losses.append(float(step(xb, yb)))
            step_s.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t_epoch)
    with torch.no_grad():
        acc = float((dp.eval()(x).argmax(1) == y).float().mean())
    dp.train()
    xb, yb = x[:MNIST_BATCH], y[:MNIST_BATCH]
    prof = profile_row(lambda: [step(xb, yb) for _ in range(20)], "config 3 MLP, 20 DataParallel steps")
    per_epoch = len(loader)
    first, last = losses[:per_epoch], losses[-per_epoch:]
    median = sorted(step_s)[len(step_s) // 2]
    print(json.dumps({
        "phase": "main_path", "path": "DataParallel MLP on MNIST-shaped data (BASELINE config 3), world size 1",
        "rows": MNIST_N, "batch": MNIST_BATCH, "epochs": MNIST_EPOCHS, "optimizer": "adam", "lr": MNIST_LR,
        "steps": len(losses), "precision": "float32, matmul TF32 off (torch's default)",
        "samples_per_s": MNIST_N * MNIST_EPOCHS / sum(epoch_s), "step_ms_median": median * 1e3,
        "epoch_s": epoch_s, "first_epoch_loss": sum(first) / len(first), "last_epoch_loss": sum(last) / len(last),
        "train_accuracy": acc, "device_idle_share": prof["device_idle_share"], "profile": prof,
        "step_vs_plain_torch": "bit for bit", "card": smi}), flush=True)
    if not all(v == v for v in losses) or not sum(last) < sum(first):
        fail(f"config 3: the loss did not fall: {sum(first) / len(first)} -> {sum(last) / len(last)}")
    if not acc > MNIST_ACC:
        fail(f"config 3: train accuracy {acc} <= {MNIST_ACC}")


def conv_profile(fn, label: str) -> dict:
    """One profiled call of ``fn``: the top device kernels and cuDNN's
    convolutions' share of the device time."""
    prof, wall = profiled(fn, label, cpu=True)
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in device_events(prof)
               if e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    if busy <= 0:
        fail(f"{label}: the profiler saw no device time")
    conv = sum(ms for name, ms, _ in kernels if any(w in name.lower() for w in CONV_WORDS))
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    return {"phase": "where_time_goes", "path": label, "wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / (wall * 1e3), "conv_ms": conv, "conv_share_of_busy": conv / busy,
            "top_kernels": [{"name": n[:120], "ms": round(ms, 3), "launches": c} for n, ms, c in top]}


def config4_world_one(ht, smi: str) -> None:
    """BASELINE config 4's model at world size 1: ``resnet50()`` (1000
    classes) on one synthetic (64, 3, 224, 224) float32 batch, random
    labels, DataParallel with SGD lr 0.05, momentum 0.9, 20 steps in
    torch's default precision (TF32 convolutions): the loss on the batch
    falls (at this rate from scratch it first jumps, then falls steadily;
    on two alternating random batches it does not fall reliably)."""
    import torch

    torch.manual_seed(0)
    model = ht.nn.models.resnet50()
    dp = ht.nn.DataParallel(model, optimizer=ht.optim.DataParallelOptimizer("sgd", lr=R50_LR, momentum=R50_MOMENTUM))
    step = dp.make_train_step(ht.nn.functional.cross_entropy)
    g = torch.Generator(device="cuda").manual_seed(4)
    batch = (torch.randn(R50_BATCH, 3, 224, 224, generator=g, device="cuda"),
             torch.randint(0, R50_CLASSES, (R50_BATCH,), generator=g, device="cuda"))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # torch's default for the timed run
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, step_s = [], []
        for i in range(R50_STEPS):
            t0 = time.perf_counter()
            losses.append(float(step(*batch)))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        prof = conv_profile(lambda: step(*batch), "ResNet-50 DataParallel step, batch 64, TF32 convolutions")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    median = sorted(step_s[1:])[len(step_s[1:]) // 2]
    print(json.dumps({
        "phase": "main_path", "path": "DataParallel ResNet-50 (BASELINE config 4's model), world size 1",
        "params": sum(p.numel() for p in model.parameters()), "batch": [R50_BATCH, 3, 224, 224],
        "classes": R50_CLASSES, "optimizer": "sgd", "lr": R50_LR, "momentum": R50_MOMENTUM, "steps": R50_STEPS,
        "precision": "float32, TF32 convolutions (torch's default), matmul TF32 off",
        "first_step_ms": step_s[0] * 1e3, "step_ms_median": median * 1e3, "images_per_s": R50_BATCH / median,
        "peak_mem_bytes": peak, "losses": [round(v, 4) for v in losses], "card": smi}), flush=True)
    print(json.dumps(prof), flush=True)
    if not all(v == v for v in losses) or not losses[-1] < losses[0]:
        fail(f"config 4: the ResNet-50 loss did not fall: {losses}")


def _daso_emulation(ht, x, y, rows: int, steps: int):
    """DASO over 2 groups of 1 in one process: two replicas from seed 3,
    each trains on its half of every global batch, then the schedule of
    DASO_2R (full average in warmup; every global_skip steps an average
    snapshotted and blended stale_steps later at weight 0.5)."""
    import copy

    import torch

    torch.manual_seed(3)
    reps = [ht.nn.models.resnet50()]
    reps.append(copy.deepcopy(reps[0]))
    opts = [torch.optim.SGD(m.parameters(), lr=R50_LR, momentum=R50_MOMENTUM) for m in reps]
    pending, w = None, 0.5
    for t in range(1, steps + 1):
        for r, (m, opt) in enumerate(zip(reps, opts)):
            m.train()
            _plain_step(m, opt, x[t - 1][r * rows:(r + 1) * rows], y[t - 1][r * rows:(r + 1) * rows],
                        ht.nn.functional.cross_entropy)
        params = [list(m.parameters()) for m in reps]
        with torch.no_grad():
            if t <= DASO_2R["warmup_steps"]:
                for a, b in zip(*params):
                    avg = (a + b) / 2
                    a.copy_(avg)
                    b.copy_(avg)
            else:
                if pending is not None and t >= pending[1]:
                    for reps_p in params:
                        for p, avg in zip(reps_p, pending[0]):
                            p.copy_((1.0 - w) * p + w * avg)
                    pending = None
                if t % DASO_2R["global_skip"] == 0 and pending is None:
                    pending = ([(a + b) / 2 for a, b in zip(*params)], t + DASO_2R["stale_steps"])
    return reps


def dp_rank(ht, rank: int) -> dict:
    """A rank's part of ``two_rank_world``, the two-rank data-parallel phase:
    config 3's MLP and ResNet-50, one DataParallel step each against world
    size 1 on this card; DASO over 2 groups x 1 against its one-process
    emulation; all in IEEE float32 (``_full_float32``)."""
    import torch
    from heat_tpu_torch.linalg.basics import _full_float32
    from heat_tpu_torch.optim.dp_optimizer import _drain

    torch.backends.cudnn.deterministic = True  # the same convolution algorithms on both sides of each check
    comm = ht.core.communication.get_comm()
    ce = ht.nn.functional.cross_entropy
    res = {"rank": rank}
    with _full_float32():
        # config 3's MLP: one step on a ragged global batch (129 | 128 rows)
        x, y = mnist_synthetic(DP_2R_MLP_ROWS, 5)
        sl = comm.chunk(x.shape, 0)[2][0]
        torch.manual_seed(1 + rank)  # each rank its own weights: DataParallel broadcasts rank 0's
        model = mnist_model(ht)
        comm.reset_traffic()
        t0 = time.perf_counter()
        # SGD, not config 3's Adam: Adam's first step is lr * g / (|g| + eps), +-lr for
        # every gradient above eps, whose sign float32 noise decides where g is ~0
        loss = ht.nn.DataParallel(model, optimizer=ht.optim.DataParallelOptimizer(
            "sgd", lr=R50_LR, momentum=R50_MOMENTUM)).make_train_step(ce)(x[sl], y[sl])
        torch.cuda.synchronize()
        res["mlp_step_ms"] = (time.perf_counter() - t0) * 1e3
        torch.manual_seed(1)
        one = mnist_model(ht)
        loss_one = _plain_step(one, torch.optim.SGD(one.parameters(), lr=R50_LR, momentum=R50_MOMENTUM), x, y,
                               ce)
        res["mlp"] = {"rows": list(sl.indices(DP_2R_MLP_ROWS))[:2], "loss_rel_err": float(
            abs(loss - loss_one) / abs(loss_one)), "worst": max_rel_err(model.state_dict(), one.state_dict()),
            "traffic": comm.traffic(), "transport": {op: comm.transport(loss, op) for op in
                                                     ("Allreduce", "Allgather", "Bcast")}}
        del model, one
        # ResNet-50: one step, 8 images a rank, the global batch's BatchNorm; in
        # float32 (loss held, parameters reported) and in float64 (parameters held)
        g = torch.Generator(device="cuda").manual_seed(6)
        rows = 2 * DP_2R_R50_ROWS
        x = torch.randn(rows, 3, 224, 224, generator=g, device="cuda")
        y = torch.randint(0, R50_CLASSES, (rows,), generator=g, device="cuda")
        mine = slice(rank * DP_2R_R50_ROWS, (rank + 1) * DP_2R_R50_ROWS)
        states = {}
        for dtype in (torch.float32, torch.float64):
            torch.manual_seed(2 + rank)
            model = ht.nn.models.resnet50().to(dtype)
            comm.reset_traffic()
            t0 = time.perf_counter()
            loss = ht.nn.DataParallel(model, optimizer=ht.optim.DataParallelOptimizer(
                "sgd", lr=R50_LR, momentum=R50_MOMENTUM)).make_train_step(ce)(x[mine].to(dtype), y[mine])
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
            torch.manual_seed(2)
            one = ht.nn.models.resnet50().to(dtype)
            loss_one = _plain_step(one, torch.optim.SGD(one.parameters(), lr=R50_LR, momentum=R50_MOMENTUM),
                                   x.to(dtype), y, ce)
            states[dtype] = (model.state_dict(), one.state_dict())
            res[f"r50_{str(dtype)[6:]}"] = {
                "step_ms": step_ms, "loss_rel_err": float(abs(loss - loss_one) / abs(loss_one)),
                "worst": max_rel_err(model.state_dict(), one.state_dict()), "traffic": comm.traffic()}
            del model, one
        # float32's distance from float64 at world size 1 and over 2 ranks
        (dp32, one32), (_, one64) = states[torch.float32], states[torch.float64]
        res["r50_float32"]["world_one_vs_float64"] = max_rel_err(one32, one64)
        res["r50_float32"]["two_ranks_vs_float64"] = max_rel_err(dp32, one64)
        del states, dp32, one32, one64
        # DASO: 2 groups x 1, 8 steps of 8 images a rank
        xs = [torch.randn(rows, 3, 224, 224, generator=g, device="cuda") for _ in range(DASO_2R_STEPS)]
        ys = [torch.randint(0, R50_CLASSES, (rows,), generator=g, device="cuda") for _ in range(DASO_2R_STEPS)]
        torch.manual_seed(3 + rank)
        model = ht.nn.models.resnet50()
        daso = ht.optim.DASO(ht.optim.DataParallelOptimizer("sgd", lr=R50_LR, momentum=R50_MOMENTUM), **DASO_2R)
        daso.init(model)
        losses, step_ms = [], []
        for t in range(DASO_2R_STEPS):
            t0 = time.perf_counter()
            losses.append(float(daso.step(ce, xs[t][mine], ys[t][mine])))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        consolidated = daso.consolidated_params()
        _drain(daso._pending)  # the average dispatched at the last step
        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        mean = sum(comm.Allgather(flat)) / 2
        off, worst_mean = 0, 0.0
        for name, p in consolidated.items():
            ref = mean[off: off + p.numel()].view_as(p)
            worst_mean = max(worst_mean, float((p - ref).abs().max() / ref.abs().max().clamp_min(1e-30)))
            off += p.numel()
        emulated = _daso_emulation(ht, xs, ys, DP_2R_R50_ROWS, DASO_2R_STEPS)[rank]
        res["daso"] = {"losses": losses, "step_ms": step_ms, "worst": max_rel_err(model.state_dict(),
                                                                                   emulated.state_dict()),
                       "consolidated_vs_mean": worst_mean, "dcn_traffic": daso.dcn.traffic(),
                       "groups": [list(daso.ici.ranks), list(daso.dcn.ranks)],
                       "devices": sorted({str(p.device) for p in model.parameters()})}
    return res


def data_parallel_two_ranks(smi: str, results: dict) -> None:
    """The two-rank data-parallel phase: checks what ``dp_rank`` reported
    from each of 2 processes on this card over gloo (``results``) against
    DP_2R_RTOL and prints rank 0's line."""
    for rank, res in sorted(results.items()):
        for key, rtol in (("mlp", DP_2R_RTOL), ("r50_float64", DP_2R_F64_RTOL), ("daso", DP_2R_RTOL)):
            worst = res[key]["worst"]
            if not worst[1] <= rtol or not res[key].get("loss_rel_err", 0.0) <= rtol:
                fail(f"rank {rank}: {key} against world size 1 (DASO: its emulation) beyond {rtol}: "
                     f"{worst}, loss {res[key].get('loss_rel_err')}")
        if not res["r50_float32"]["loss_rel_err"] <= DP_2R_RTOL:
            fail(f"rank {rank}: the float32 ResNet-50 loss against world size 1: {res['r50_float32']}")
        if not res["daso"]["consolidated_vs_mean"] <= DP_2R_RTOL:
            fail(f"rank {rank}: consolidated_params is not the ranks' mean: {res['daso']['consolidated_vs_mean']}")
        if res["daso"]["devices"] != ["cuda:0"]:
            fail(f"rank {rank}: DASO's parameters left the card: {res['daso']['devices']}")
    r0 = results[0]
    print(json.dumps({
        "phase": "data_parallel_two_ranks", "note": "2 processes on ONE card over gloo: not a multi-card figure",
        "precision": "IEEE float32 (_full_float32: matmul and cuDNN convolutions)", "rtol": DP_2R_RTOL,
        "mlp": {"rows": DP_2R_MLP_ROWS, "step_ms": r0["mlp_step_ms"], **r0["mlp"]},
        "resnet50_float32": {"rows_per_rank": DP_2R_R50_ROWS, **r0["r50_float32"]},
        "resnet50_float64": {"rows_per_rank": DP_2R_R50_ROWS, "rtol": DP_2R_F64_RTOL, **r0["r50_float64"]},
        "daso": {**DASO_2R, "steps": DASO_2R_STEPS, **r0["daso"], "rank1_worst": results[1]["daso"]["worst"]},
        "card": smi}), flush=True)


# ---------------------------------------------------------------------- #
# the estimators and the tiled resplit under a byte budget
# ---------------------------------------------------------------------- #
EST_ITER = 5  # KMedians, KMedoids and BatchParallelKMedians steps at X's size (BatchParallelKMeans: MAX_ITER)
EST_SEED = 15
EST_TRAIN_STRIDE = 100  # KNN's 1e6 training rows: every 100th row of X (create_clusters lays a blob out in one run)
EST_QUERIES, EST_CHECK_QUERIES = 32768, 256
EST_PEAK = 70e9  # bytes: no estimator may hold more on the card at X's size
PCA_RANK, PCA_NOISE, PCA_RTOL = 16, 1e-3, 1e-4  # T = a rank-16 signal plus 1e-3 noise, config 1's shape
NB_RTOL, LASSO_RTOL, DMD_TOL = 1e-5, 1e-4, 1e-3
SCALER_RTOL = 1e-5
SPECTRAL_N, SPECTRAL_K, SPECTRAL_LANCZOS, SPECTRAL_AGREE = 32768, 8, 300, 0.99
SPECTRAL_GAMMA = 1.0 / (4 * D)  # rbf's sigma^2 = 2d: a blob's rows at ~e^-1/2, other blobs' at ~0
RESPLIT_2R_SHAPE, RESPLIT_2R_BUDGET = (4096, 1024, 66), 64 << 20  # 1.1 GB; tiles of 4 slices of axis 2, the last 2
RESPLIT_2R_CASES = ((0, 1), (0, None), (None, 0))
EST_2R_N, EST_2R_K, EST_2R_RTOL = 100_001, 8, 1e-4


def _zero_launches() -> None:
    from heat_tpu_torch.ops import kmeans_kernels as kk

    for key in kk.launch_counts:
        kk.launch_counts[key] = 0


def _launches() -> dict:
    from heat_tpu_torch.ops import kmeans_kernels as kk

    return dict(kk.launch_counts)


def profiled_launches(fn, label: str) -> tuple:
    """(the launches of the ``assign`` and ``em_stats`` kernels that the
    profiler saw over one ``fn()``, the wrappers' counts over that same
    call).  A session that saw fewer launches of a kernel than its wrapper
    counted lost records, and ``profiled`` takes it again."""
    def seen(prof) -> dict:
        return {key: sum(e.count for e in device_events(prof) if f"{key}_kernel" in e.key)
                for key in ("assign", "em_stats")}

    def run():
        _zero_launches()
        fn()

    prof, _ = profiled(run, label, complete=lambda p: all(n >= _launches()[key] for key, n in seen(p).items()))
    return seen(prof), _launches()


def _est_fit(fn):
    """(result, ms, launch counts, peak bytes) of one ``fn()`` on the card,
    the counts zeroed and the peak reset just before."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    out, ms = once_ms(fn)
    return out, ms, _launches(), torch.cuda.max_memory_allocated()


def _est_row(name: str, ms: float, bound: tuple, peak: int, check: str, err, tol, launches, smi: str,
             predict_ms=None, **extra) -> dict:
    if peak > EST_PEAK:
        fail(f"{name}: {peak} bytes at the peak, past {EST_PEAK}")
    if err is not None and not err <= tol:
        fail(f"{name}: {check}: error {err} past {tol}")
    row = {"phase": "estimators", "estimator": name, "fit_ms": ms, "predict_ms": predict_ms, "bound_ms": bound[0],
           "bound_by": bound[1], "share_of_bound": bound[0] / ms, "peak_mem_bytes": peak, "check": check,
           "err": err, "tol": tol, "launches": launches, "card": smi, **extra}
    print(json.dumps(row), flush=True)
    return row


def _medians64(x, labels, k: int):
    """float64 (k, d) coordinate-wise medians of each label's rows (the mean
    of the two middles), by a sort of each cluster's rows: independent of
    the port's key selection."""
    import torch

    order = torch.argsort(labels.long(), stable=True)
    counts = torch.bincount(labels.long(), minlength=k).tolist()
    out = torch.zeros((k, x.shape[1]), dtype=torch.float64, device=x.device)
    start = 0
    for c, cnt in enumerate(counts):
        if cnt:
            s = torch.sort(x[order[start:start + cnt]].double(), 0).values
            out[c] = (s[(cnt - 1) // 2] + s[cnt // 2]) / 2
        start += cnt
    return out, order, counts


def _kcluster_checks(ht, X, est, name: str):
    """(check text, error): one more step of ``name`` from the fitted
    centers C, against float64 on the card.  KMedians: the step's centers
    are the float64 medians of the labels of C (``labels_``), exactly.
    KMedoids: each of the step's medoids is a row of its cluster and as near
    to the cluster's float64 median as any member (within float32 rounding
    of the distance)."""
    import torch

    C = est.cluster_centers_.larray.float()
    step = getattr(ht.cluster, name)(n_clusters=C.shape[0], init=C, max_iter=1).fit(X).cluster_centers_.larray
    xl, labels = X.larray, est.labels_.larray
    med, order, counts = _medians64(xl, labels, C.shape[0])
    if name == "KMedians":
        err = float((step.double() - med.float().double()).abs().max())
        return "one step's centres equal the float64 medians of the fit's labels", err
    worst, start = 0.0, 0
    for c, cnt in enumerate(counts):
        if cnt:
            rows = xl[order[start:start + cnt]].double()
            dm = ((rows - med[c]) ** 2).sum(1)
            if float(((rows - step[c].double()) ** 2).sum(1).min()) != 0.0:
                fail(f"KMedoids: medoid {c} is no row of its cluster")
            got = float(((step[c].double() - med[c]) ** 2).sum())
            worst = max(worst, (got - float(dm.min())) / max(float(dm.min()), 1e-30))
        start += cnt
    return "one step's medoids: member rows, their squared distance to the float64 median over the nearest member's", worst


def _agreement(labels, truth, k: int) -> float:
    """The share of rows whose label maps to their true label under the best
    one-to-one mapping found greedily from the contingency table."""
    import torch

    table = torch.zeros((k, k), dtype=torch.int64, device=labels.device)
    table.index_put_((labels.long(), truth.long()), torch.ones_like(labels, dtype=torch.int64), accumulate=True)
    t = table.cpu().clone()
    hit = 0
    for _ in range(k):
        v = int(t.max())
        i, j = divmod(int(t.argmax()), k)
        hit += v
        t[i, :] = -1
        t[:, j] = -1
    return hit / labels.numel()


def _cd64(G, b, lam_n: float, max_iter: int, tol: float):
    """The reference's cyclic coordinate descent in float64 on the host, from
    the Gram G = AᵀA and b = Aᵀy of A = [1, X]: (θ, sweeps)."""
    import numpy as np

    G, b = G.cpu().numpy(), b.cpu().numpy()
    theta = np.zeros(G.shape[0])
    col = np.maximum(np.diag(G), 1e-30)
    for it in range(max_iter):
        old = theta.copy()
        for j in range(G.shape[0]):
            rho = b[j] - G[j] @ theta + G[j, j] * theta[j]
            if j == 0:
                theta[j] = rho / col[0]
            else:
                theta[j] = np.sign(rho) * max(abs(rho) - lam_n / 2, 0.0) / col[j]
        if np.abs(theta - old).max() < tol:
            return theta, it + 1
    return theta, max_iter


def estimators_world_one(ht, smi: str) -> None:
    """The estimators at world size 1 at users' sizes: X = ``create_clusters
    (1e8, 32, 64)`` (config 2's data) with its blob labels y; T, a rank-16
    signal plus noise at config 1's 1e6 x 256; R = randn(1e6, 256) for
    Lasso; DMD's snapshots of a known rank-16 system at 1e6 x 256; S =
    ``create_clusters(32768, 32, 8)`` for Spectral.  Each fit held against
    float64 on the card, its launch counts read just after (zeroed just
    before), timed beside its bound, its peak memory under EST_PEAK."""
    import numpy as np
    import torch

    from heat_tpu_torch.ops import kmeans_kernels as kk

    t_phase = time.perf_counter()
    n, d, k = N_MAIN, D, K
    gm = torch.Generator().manual_seed(EST_SEED)
    means = torch.rand((k, d), generator=gm) * 40.0 - 20.0
    X = ht.utils.data.create_clusters(n, d, k, means.numpy(), cluster_std=1.0, device="gpu", random_state=EST_SEED)
    xl = X.larray
    per = n // k
    y_t = (torch.arange(n, device="cuda") // per).clamp_max_(k - 1).to(torch.int32)
    y = ht.array(y_t, split=0)
    xbytes = n * d * 4
    init = xl[torch.arange(k, device="cuda") * per + 7].float().clone()  # a row of each blob
    assign_ops = 2.0 * n * k * d

    # the k-clusterers: each step is the assign kernel, then the medians
    for name in ("KMedians", "KMedoids"):
        est, ms, launches, peak = _est_fit(lambda name=name: getattr(ht.cluster, name)(
            n_clusters=k, init=init, max_iter=EST_ITER).fit(X))
        if launches != {"assign": est.n_iter_ + 1, "em_stats": 0}:
            fail(f"{name}: launches {launches}, not assign once a step and once for the labels")
        pred, pms = once_ms(lambda est=est: est.predict(X))
        if not torch.equal(pred.larray, est.labels_.larray):
            fail(f"{name}: predict differs from the fit's labels")
        check, err = _kcluster_checks(ht, X, est, name)
        steps = est.n_iter_
        bound = stats_bound_ms(xbytes * (2 * steps + 1), 8.0 * n * (steps + 1), assign_ops * (steps + 1))
        extra = {"recovered": recovered(est.cluster_centers_.larray.float(), means.cuda(), RECOVER_TOL),
                 "recovered_of": k, "recover_tol": RECOVER_TOL} if name == "KMedians" else {}
        _est_row(name, ms, bound, peak, check, err, 0.0 if name == "KMedians" else 1e-5, launches, smi,
                 predict_ms=pms, n_iter=steps, **extra)
        del est, pred
    # the profiler's count of one KMedians fit's kernels
    seen, counts = profiled_launches(lambda: ht.cluster.KMedians(n_clusters=k, init=init, max_iter=2).fit(X),
                                     "KMedians launches")
    if seen["em_stats"] or not seen["assign"]:
        fail(f"KMedians: the profiler saw {seen}")
    print(json.dumps({"phase": "estimators_profiled_launches", "estimator": "KMedians(max_iter=2)", "kernels": seen,
                      "launch_counts": counts, "card": smi}), flush=True)

    for name, median in (("BatchParallelKMeans", False), ("BatchParallelKMedians", True)):
        kw = {"max_iter": EST_ITER if median else MAX_ITER}
        est, ms, launches, peak = _est_fit(lambda name=name, kw=kw: getattr(ht.cluster, name)(
            n_clusters=k, random_state=0, **kw).fit(X))
        if median and (launches["em_stats"] or launches["assign"] < est.n_iter_ + 1):
            fail(f"{name}: launches {launches}")
        if not median and (launches["em_stats"] < est.n_iter_ or launches["assign"] != 1):
            fail(f"{name}: launches {launches}")
        C = est.cluster_centers_.larray.float()
        if tuple(C.shape) != (k, d) or not bool(torch.isfinite(C).all()):
            fail(f"{name}: centres are not finite (k, d)")
        lab = kk.fused_assign(xl, C)[0]
        if not torch.equal(lab, est.labels_.larray):
            fail(f"{name}: labels differ from the assign kernel's of the centres")
        steps = est.n_iter_
        bound = stats_bound_ms(xbytes * (steps * (1 + median) + 1), 0.0, assign_ops * (steps + 1))
        _est_row(name, ms, bound, peak, "labels are the assign kernel's of the merged centres; centres finite",
                 None, None, launches, smi, n_iter=steps, recovered=recovered(C, means.cuda(), RECOVER_TOL),
                 recovered_of=k)
        del est
    seen, counts = profiled_launches(
        lambda: ht.cluster.BatchParallelKMeans(n_clusters=k, random_state=0, max_iter=3).fit(X),
        "BatchParallelKMeans launches")
    if not seen["em_stats"]:
        fail(f"BatchParallelKMeans: the profiler saw {seen}")
    print(json.dumps({"phase": "estimators_profiled_launches", "estimator": "BatchParallelKMeans(max_iter=3)",
                      "kernels": seen, "launch_counts": counts, "card": smi}), flush=True)

    # GaussianNB: per-class moments against float64 over each blob's rows
    nb, ms, launches, peak = _est_fit(lambda: ht.naive_bayes.GaussianNB().fit(X, y))
    pred, pms = once_ms(lambda: nb.predict(X))
    mu64 = torch.stack([xl[c * per:(c + 1) * per if c < k - 1 else n].double().mean(0) for c in range(k)])
    var64 = torch.stack([xl[c * per:(c + 1) * per if c < k - 1 else n].double().var(0, unbiased=False)
                         for c in range(k)])
    err = max(_max_err64(nb.theta_.larray, mu64), _max_err64(nb.var_.larray - nb.epsilon_, var64))
    acc = float((pred.larray == y_t).double().mean())
    _est_row("GaussianNB", ms, stats_bound_ms(xbytes + 4 * n, 4.0 * n, 4.0 * n * d * k), peak,
             "theta and var (smoothing off) against float64 per blob", err, NB_RTOL, launches, smi, predict_ms=pms,
             predict_accuracy=acc)
    if acc < 0.999:
        fail(f"GaussianNB: predicts {acc} of the blobs")
    del nb, pred

    # the scalers: statistics against float64, transforms against the formula in float64 on 1e6 rows
    head = xl[:1_000_000].double()
    sorted_cols = None
    for kind in ("StandardScaler", "MinMaxScaler", "MaxAbsScaler", "RobustScaler", "Normalizer"):
        sc, ms, launches, peak = _est_fit(lambda kind=kind: getattr(ht.preprocessing, kind)().fit(X))
        tr, tms = once_ms(lambda sc=sc: sc.transform(X))
        if kind == "StandardScaler":
            m64 = _chunked64(xl, lambda b: b.sum(0)) / n
            v64 = _chunked64(xl, lambda b: ((b - m64) ** 2).sum(0)) / n
            err = max(_max_err64(sc.mean_.larray, m64), _max_err64(sc.var_.larray, v64))
            want = (head - sc.mean_.larray.double()) / sc.scale_.larray.double()
        elif kind == "MinMaxScaler":
            err = float(not (torch.equal(sc.data_min_.larray, xl.amin(0)) and torch.equal(sc.data_max_.larray,
                                                                                        xl.amax(0))))
            want = head * sc.scale_.larray.double() + sc.min_.larray.double()
        elif kind == "MaxAbsScaler":
            err = float(not torch.equal(sc.max_abs_.larray, xl.abs().amax(0)))
            want = head / sc.scale_.larray.double()
        elif kind == "RobustScaler":
            qs = []
            for j in range(d):
                s = torch.sort(xl[:, j]).values.double()
                q = []
                for p in (50.0, 25.0, 75.0):
                    pos = (n - 1) * p / 100.0
                    lo = int(np.floor(pos))
                    q.append(s[lo] + (s[min(lo + 1, n - 1)] - s[lo]) * (pos - lo))
                qs.append(torch.stack(q))
                del s
            q64 = torch.stack(qs, 1)
            err = max(_max_err64(sc.center_.larray, q64[0]), _max_err64(sc.scale_.larray, q64[2] - q64[1]))
            want = (head - sc.center_.larray.double()) / sc.scale_.larray.double()
        else:
            err = 0.0
            want = head / head.norm(dim=1, keepdim=True)
        terr = _max_err64(tr.larray[:1_000_000], want)
        if tr.split != 0 or not tr.larray.is_cuda:
            fail(f"{kind}: transform left split 0 or the card")
        reads = {"RobustScaler": 2 * xbytes, "Normalizer": 0}.get(kind, xbytes)
        _est_row(kind, ms, stats_bound_ms(reads, 0.0), peak, "statistics against float64 (min/max bit for bit), "
                 "the transform of 1e6 rows against its formula in float64", max(err, terr), SCALER_RTOL, launches,
                 smi, predict_ms=tms, transform_bound_ms=stats_bound_ms(xbytes, xbytes)[0])
        del sc, tr
    del head
    torch.cuda.empty_cache()

    # KNN: 1e6 training rows (every 100th of X), 32768 queries
    train, ytr = X[::EST_TRAIN_STRIDE], y[::EST_TRAIN_STRIDE]
    g = torch.Generator(device="cuda").manual_seed(EST_SEED)
    q = xl[torch.randint(0, n, (EST_QUERIES,), generator=g, device="cuda")] + 0.5 * torch.randn(
        EST_QUERIES, d, generator=g, device="cuda")
    knn, ms, launches, peak = _est_fit(lambda: ht.classification.KNeighborsClassifier(5).fit(train, ytr))
    pred, pms = once_ms(lambda: knn.predict(ht.array(q, split=0)))
    tl, qc = train.larray.double(), q[:EST_CHECK_QUERIES].double()
    d2 = (qc * qc).sum(1, keepdim=True) + (tl * tl).sum(1)[None, :] - 2.0 * qc @ tl.T
    votes = ytr.larray[d2.topk(5, 1, largest=False).indices].long()
    want = torch.stack([torch.bincount(v, minlength=k).argmax() for v in votes]).to(torch.int32)
    wrong = int((pred.larray[:EST_CHECK_QUERIES] != want).sum())
    nt = train.shape[0]
    _est_row("KNeighborsClassifier", ms, stats_bound_ms(nt * d * 4 + EST_QUERIES * d * 4, EST_QUERIES * 4,
                                                        2.0 * EST_QUERIES * nt * d), peak,
             f"the float64 brute force's votes on {EST_CHECK_QUERIES} queries", float(wrong), 0.0, launches, smi,
             predict_ms=pms, train_rows=nt, queries=EST_QUERIES)
    del knn, pred, tl, qc, d2, train, ytr, q
    del X, xl, y, y_t
    torch.cuda.empty_cache()

    # PCA and IncrementalPCA on T, config 1's shape
    m, f = 1_000_000, 256
    g = torch.Generator(device="cuda").manual_seed(EST_SEED + 1)
    T = (torch.randn(m, PCA_RANK, generator=g, device="cuda") @ (torch.randn(PCA_RANK, f, generator=g, device="cuda")
                                                                   * torch.linspace(4, 1, PCA_RANK, device="cuda")[:, None])
         + PCA_NOISE * torch.randn(m, f, generator=g, device="cuda") + 3.0)
    t = ht.array(T, split=0)
    tc = T.double() - T.double().mean(0)
    ev64 = torch.linalg.eigvalsh(tc.T @ tc).flip(0).clamp_min(0)
    s64 = ev64.sqrt()
    ratio64 = ev64 / ev64.sum()
    del tc
    tbytes = m * f * 4
    for solver, comps in (("full", PCA_RANK), ("hierarchical", PCA_RANK), ("randomized", PCA_RANK), ("full", 0.9)):
        pca, ms, launches, peak = _est_fit(lambda solver=solver, comps=comps: ht.decomposition.PCA(
            n_components=comps, svd_solver=solver).fit(t))
        tr, tms = once_ms(lambda pca=pca: pca.transform(t))
        kc = pca.n_components_
        if isinstance(comps, float):
            want_k = int(torch.searchsorted(torch.cumsum(ratio64, 0), torch.tensor([comps], dtype=torch.float64,
                                                                                   device="cuda"))) + 1
            if kc != want_k:
                fail(f"PCA({comps}): {kc} components, float64's {want_k}")
        err = float(((pca.singular_values_.larray.double() - s64[:kc]).abs() / s64[:kc]).max())
        _est_row(f"PCA({solver}, {comps})", ms, stats_bound_ms(2 * tbytes, 0.0, 2.0 * m * f * f), peak,
                 "singular values against the float64 Gram's", err, PCA_RTOL, launches, smi, predict_ms=tms,
                 n_components=kc)
        del pca, tr
    ipca, ms, launches, peak = _est_fit(lambda: ht.decomposition.IncrementalPCA(PCA_RANK, batch_size=65536).fit(t))
    err = float(((ipca.singular_values_.larray.double() - s64[:PCA_RANK]).abs() / s64[:PCA_RANK]).max())
    _est_row("IncrementalPCA(16, 65536)", ms, stats_bound_ms(tbytes, 0.0, 2.0 * m * f * (PCA_RANK + 65536 // 16)),
             peak, "singular values against the float64 Gram's", err, PCA_RTOL, launches, smi)
    del ipca, t, T
    torch.cuda.empty_cache()

    # Lasso on R = randn(1e6, 256), y from a 16-sparse theta plus noise
    R = torch.randn(m, f, generator=g, device="cuda")
    theta = torch.zeros(f, dtype=torch.float64, device="cuda")
    theta[torch.randperm(f, generator=g, device="cuda")[:16]] = torch.linspace(-2, 2, 16, dtype=torch.float64,
                                                                               device="cuda")
    yl = (R.double() @ theta + 0.5 + 0.01 * torch.randn(m, generator=g, device="cuda", dtype=torch.float64)).float()
    lam = 0.01
    lasso, ms, launches, peak = _est_fit(lambda: ht.regression.Lasso(lam=lam, max_iter=100, tol=1e-6).fit(
        ht.array(R, split=0), ht.array(yl, split=0)))
    A64 = torch.cat([torch.ones(m, 1, dtype=torch.float64, device="cuda"), R.double()], 1)
    th64, it64 = _cd64(A64.T @ A64, A64.T @ yl.double(), lam * m, 100, 1e-6)
    del A64
    got = lasso.theta.larray.double().reshape(-1).cpu().numpy()
    err = float(np.abs(got - th64).max() / np.abs(th64).max())
    _est_row("Lasso", ms, stats_bound_ms(m * f * 4 + m * 4, 0.0, 2.0 * m * (f + 1) ** 2), peak,
             "theta against float64 coordinate descent", err, LASSO_RTOL, launches, smi, n_iter=lasso.n_iter_,
             n_iter_float64=it64)
    del R, yl, lasso

    # DMD of a known rank-16 linear system's 256 snapshots
    r = 16
    radii = torch.linspace(0.999, 0.975, r // 2, dtype=torch.float64)
    angles = torch.linspace(0.05, 0.4, r // 2, dtype=torch.float64)
    block = torch.zeros((r, r), dtype=torch.float64)
    for i in range(r // 2):
        c, s = float(radii[i] * torch.cos(angles[i])), float(radii[i] * torch.sin(angles[i]))
        block[2 * i:2 * i + 2, 2 * i:2 * i + 2] = torch.tensor([[c, -s], [s, c]], dtype=torch.float64)
    known = torch.cat([radii * torch.exp(1j * angles), radii * torch.exp(-1j * angles)])
    z = torch.randn(r, dtype=torch.float64, generator=torch.Generator().manual_seed(EST_SEED))
    zs = []
    for _ in range(f):
        zs.append(z)
        z = block @ z
    Z = torch.stack(zs, 1).cuda()
    Q = torch.linalg.qr(torch.randn(m, r, generator=g, device="cuda", dtype=torch.float64)).Q
    S = (Q @ Z).float()
    del Q
    dmd, ms, launches, peak = _est_fit(lambda: ht.decomposition.DMD(svd_rank=r).fit(ht.array(S, split=0)))
    ev = dmd.rom_eigenvalues_.larray.cpu().to(torch.complex128)
    err = max(float((known - ev[(known[:, None] - ev[None, :]).abs().argmin(1)]).abs().max()),
              float((ev - known[(ev[:, None] - known[None, :]).abs().argmin(1)]).abs().max()))
    fc, pms = once_ms(lambda: dmd.predict(ht.array(S[:, 0], split=0), 3))
    ferr = _max_err64(fc.larray.T, S[:, 1:4].double())
    _est_row("DMD(svd_rank=16)", ms, stats_bound_ms(2 * m * f * 4, 0.0, 2.0 * m * f * f), peak,
             "eigenvalues against the system's known ones (each to its nearest)", err, DMD_TOL, launches, smi,
             predict_ms=pms, forecast_err=ferr, eig_device=str(dmd.rom_eigenvalues_.larray.device))
    if ferr > DMD_TOL:
        fail(f"DMD: the 3-step forecast is {ferr} from the snapshots")
    del S, dmd, fc
    torch.cuda.empty_cache()

    # Spectral clustering and its Laplacian at 32768 x 32, 8 blobs
    gs = torch.Generator().manual_seed(EST_SEED + 2)
    smeans = torch.rand((SPECTRAL_K, d), generator=gs) * 40.0 - 20.0
    Sx = ht.utils.data.create_clusters(SPECTRAL_N, d, SPECTRAL_K, smeans.numpy(), cluster_std=1.0, device="gpu",
                                       random_state=EST_SEED)
    sigma = (1.0 / (2.0 * SPECTRAL_GAMMA)) ** 0.5
    lap, lms, _, lpeak = _est_fit(lambda: ht.graph.Laplacian(
        lambda v: ht.spatial.rbf(v, sigma=sigma, quadratic_expansion=True)).construct(Sx))
    ll = lap.larray
    diag_err = float((ll.diagonal() - 1.0).abs().max())
    del lap, ll
    sp, ms, launches, peak = _est_fit(lambda: ht.cluster.Spectral(n_clusters=SPECTRAL_K, gamma=SPECTRAL_GAMMA,
                                                                  n_lanczos=SPECTRAL_LANCZOS).fit(Sx))
    truth = (torch.arange(SPECTRAL_N, device="cuda") // (SPECTRAL_N // SPECTRAL_K)).clamp_max_(SPECTRAL_K - 1)
    agree = _agreement(sp.labels_.larray, truth, SPECTRAL_K)
    if not launches["em_stats"] or not launches["assign"]:
        fail(f"Spectral: launches {launches}, not the KMeans kernels")
    ab = SPECTRAL_N * SPECTRAL_N * 4
    _est_row("Laplacian(norm_sym, 32768)", lms, stats_bound_ms(SPECTRAL_N * d * 4, ab, 2.0 * SPECTRAL_N ** 2 * d),
             lpeak, "the diagonal of I - D^-1/2 A D^-1/2 is 1", diag_err, 1e-6, None, smi)
    _est_row("Spectral(8, n_lanczos=300)", ms, stats_bound_ms(ab * (SPECTRAL_LANCZOS + 1), ab,
                                                              2.0 * SPECTRAL_N ** 2 * (d + SPECTRAL_LANCZOS)),
             peak, "blob labels recovered up to a permutation (share of rows)", 1.0 - agree, 1.0 - SPECTRAL_AGREE,
             launches, smi, agreement=agree)
    del sp, Sx
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "estimators_seconds", "seconds": time.perf_counter() - t_phase, "card": smi}),
          flush=True)


def tiled_resplit_case(ht, comm, src, dst, budget: int) -> dict:
    """The tiled resplit of RESPLIT_2R_SHAPE against the monolithic one on
    this rank: bit for bit, the same traffic bytes, and the transient memory
    beyond source and destination of each (``max_memory_allocated`` past
    what was live, less the destination)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(EST_SEED + 3)
    full = torch.randn(RESPLIT_2R_SHAPE, generator=g, device="cuda")
    x = ht.array(full, split=src)
    del full
    torch.cuda.empty_cache()
    out = {}
    for label, b in (("monolithic", 0), ("tiled", budget)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        comm.reset_traffic()
        t0 = time.perf_counter()
        y = x.resplit(dst, memory_budget=b)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        dst_bytes = y.larray.numel() * 4
        out[label] = {"transient_bytes": torch.cuda.max_memory_allocated() - base - dst_bytes, "seconds": secs,
                      "traffic": {k: v["bytes"] for k, v in comm.traffic().items()},
                      "calls": {k: v["calls"] for k, v in comm.traffic().items()}, "dst_bytes": dst_bytes,
                      "src_bytes": x.larray.numel() * 4}
        out[label + "_value"] = y
    plan = ht.core.redistribution.plan_resplit(RESPLIT_2R_SHAPE, 4, src, dst, comm.size, budget)
    z = x.resplit(src)  # a copy of the source, resplit in place
    z.resplit_(dst, memory_budget=budget)
    res = {"equal": bool(torch.equal(out["tiled_value"].larray, out["monolithic_value"].larray)),
           "inplace_equal": bool(torch.equal(z.larray, out["monolithic_value"].larray)), "reason": plan.reason, "tiles": plan.n_tiles,
           "tile_bytes": plan.max_tile_bytes, "budget": budget, "monolithic": out["monolithic"], "tiled": out["tiled"]}
    return res


def estimator_cases(ht) -> dict:
    """Phase 3f's estimators on data every rank makes alike on the card
    (EST_2R_N rows, ragged over 2 ranks), from explicit initial centers:
    each result gathered to the host as (value, exact)."""
    import numpy as np
    import torch

    g = torch.Generator(device="cuda").manual_seed(EST_SEED + 4)
    k, d = EST_2R_K, D
    means = torch.rand(k, d, generator=g, device="cuda") * 40 - 20
    lab = torch.randint(0, k, (EST_2R_N,), generator=g, device="cuda")
    X = means[lab] + torch.randn(EST_2R_N, d, generator=g, device="cuda")
    yv = lab.to(torch.int32)
    T = torch.randn(EST_2R_N, 4, generator=g, device="cuda") @ torch.randn(4, 16, generator=g, device="cuda") + 1.0
    x, y, t = ht.array(X, split=0), ht.array(yv, split=0), ht.array(T, split=0)
    init = X[torch.stack([torch.nonzero(lab == c)[0, 0] for c in range(k)])].clone()  # a row of each blob
    out = {}

    def keep(name, v, exact):
        if hasattr(v, "larray"):
            if not v.larray.is_cuda:
                fail(f"{name}: a result left the card")
            v = v.numpy()
        out[name] = (np.asarray(v), exact)

    for name in ("KMeans", "KMedians", "KMedoids"):
        est = getattr(ht.cluster, name)(n_clusters=k, init=init, max_iter=10).fit(x)
        keep(f"{name}.centers", est.cluster_centers_, name != "KMeans")
        keep(f"{name}.labels", est.labels_, True)
        keep(f"{name}.n_iter", est.n_iter_, True)
    pca = ht.decomposition.PCA(4, svd_solver="full").fit(t)
    keep("PCA.s", pca.singular_values_, False)
    keep("PCA.abs_components", pca.components_.larray.abs().cpu(), False)
    nb = ht.naive_bayes.GaussianNB().fit(x, y)
    keep("GaussianNB.theta", nb.theta_, False)
    keep("GaussianNB.var", nb.var_, False)
    keep("GaussianNB.predict", nb.predict(x), True)
    lasso = ht.regression.Lasso(lam=0.01, tol=1e-6).fit(t, ht.array(T[:, 0] * 2 - T[:, 3] + 0.5, split=0))
    keep("Lasso.theta", lasso.theta, False)
    keep("Lasso.n_iter", lasso.n_iter_, True)
    knn = ht.classification.KNeighborsClassifier(5).fit(x, y)
    keep("KNN.predict", knn.predict(ht.array(X[:2000] + 0.3, split=0)), True)
    for kind in ("StandardScaler", "MinMaxScaler", "MaxAbsScaler", "RobustScaler", "Normalizer"):
        keep(f"{kind}.transform", getattr(ht.preprocessing, kind)().fit(x).transform(x), False)
    return out


def estimators_rank(ht, rank: int) -> dict:
    """A rank's part of ``two_rank_world``: the tiled resplit of
    RESPLIT_2R_SHAPE against the monolithic one at each of
    RESPLIT_2R_CASES, then ``estimator_cases``."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    comm = ht.core.communication.get_comm()
    res = {"resplit": {f"{s}->{d}": tiled_resplit_case(ht, comm, s, d, RESPLIT_2R_BUDGET)
                       for s, d in RESPLIT_2R_CASES}}
    torch.cuda.empty_cache()
    res["cases"] = estimator_cases(ht)
    return res


def estimators_two_ranks(ht, smi: str, results: dict, part_s: float) -> None:
    """Phase 3f: what ``estimators_rank`` reported from 2 spawned ranks on
    this card over gloo (``results``, ``part_s`` seconds on rank 0): the
    tiled resplit bit for bit the monolithic one, with the same traffic
    bytes, its transient memory within budget + one tile; then
    ``estimator_cases`` against world size 1 on this card (exact where
    marked, else within EST_2R_RTOL of the largest entry)."""
    import numpy as np

    t0 = time.perf_counter()
    want = estimator_cases(ht)
    for rank, res in sorted(results.items()):
        for case, r in res["resplit"].items():
            mono, tiled = r["monolithic"], r["tiled"]
            if r["reason"] != "tiled" or r["tiles"] < 2:
                fail(f"rank {rank}: resplit {case} planned {r['reason']} ({r['tiles']} tiles)")
            if not (r["equal"] and r["inplace_equal"]):
                fail(f"rank {rank}: the tiled resplit {case} differs from the monolithic one")
            if mono["traffic"] != tiled["traffic"]:
                fail(f"rank {rank}: resplit {case} moved {tiled['traffic']}, the monolithic one {mono['traffic']}")
            if tiled["transient_bytes"] > r["budget"] + r["tile_bytes"]:
                fail(f"rank {rank}: resplit {case} held {tiled['transient_bytes']} transient bytes, past the budget "
                     f"{r['budget']} plus one tile {r['tile_bytes']}")
            print(json.dumps({"phase": "tiled_resplit_two_ranks", "rank": rank, "case": case,
                              "shape": list(RESPLIT_2R_SHAPE), "tiles": r["tiles"], "budget": r["budget"],
                              "tile_bytes": r["tile_bytes"], "tiled": tiled, "monolithic": mono, "card": smi}),
                  flush=True)
        for name, (w, exact) in want.items():
            got = res["cases"].get(name)
            same = got is not None and got[0].shape == w.shape and (
                np.array_equal(got[0], w) if exact else
                float(np.abs(got[0] - w).max()) <= EST_2R_RTOL * max(float(np.abs(w).max()), 1.0))
            if not same:
                err = None if got is None or got[0].shape != w.shape else float(np.abs(got[0] - w).max())
                fail(f"rank {rank}: {name} differs from world size 1 (max abs difference {err})")
    print(json.dumps({"phase": "estimators_two_ranks", "note": "2 processes on ONE card over gloo, against world "
                      "size 1", "cases": len(want), "seconds": part_s + time.perf_counter() - t0, "card": smi}),
          flush=True)


# 3g. I/O, fft, convolve, sparse, vmap; then on 2 ranks ring_map and DASO's resume too
SURF_IO_SHAPE = (10_000_000, 32)  # 1.28 GB float32 on the card
SURF_CSV_SHAPE = (1_000_000, 32)
SURF_FFT_N, SURF_FFT_CHECK = 16384, 2048
SURF_CONV_N, SURF_CONV_M, SURF_CONV_CHECK = 100_000_000, 1023, 1_000_000
SURF_CONV_RTOL = 1e-5  # of the largest float64 entry: float32 rounding; TF32 products lie ~1e-3 off
SURF_SPARSE_N, SURF_SPARSE_ROW, SURF_SPARSE_K, SURF_SPARSE_CHECK = 1_000_000, 32, 64, 4096
SURF_SMALL_N, SURF_SMALL_DENSITY = 16384, 0.01
SURF_VMAP_SHAPE = (1_000_000, 32)
SURF_RTOL = 1e-5  # float32 results against float64 (of the largest entry), and 2 ranks against world size 1
SURF_2R_SIG, SURF_2R_KER = 7, 9  # a 2-rank signal whose chunks (4, 3) are shorter than the halo (8)
SURF_2R_LONG, SURF_2R_LONG_KER = 1_000_001, 1023


def conv_bound_ms(n: int, m: int) -> tuple:
    """(least ms, what bounds it) of a length-n by m-tap float32
    convolution: 2nm operations at the CUDA-core float32 peak, or the
    signal, filter and full result moved once, the larger."""
    return stats_bound_ms(4.0 * (n + m), 4.0 * (n + m - 1), 2.0 * n * m)


def spmm_bytes(rows: int, nnz: int, k: int, dense_rows: int, value: int = 4, index: int = 8) -> float:
    """Bytes a CSR (rows x dense_rows, nnz values) times dense (dense_rows,
    k) product must move: the values, column indices and row pointers once,
    the dense operand once and the (rows, k) result written once."""
    return float(nnz * (value + index) + (rows + 1) * index + dense_rows * k * value + rows * k * value)


def spmm_bound_ms(rows: int, nnz: int, k: int, dense_rows: int) -> tuple:
    return stats_bound_ms(spmm_bytes(rows, nnz, k, dense_rows), 0.0)


def hdf5_missing() -> dict:
    """The line phase 3g prints where h5py cannot be imported (the card's
    machine has none), else None."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        return {"hdf5": "h5py not installed"}
    return None


class scratch_dir:
    """A temporary directory for the phase's files, removed on the way out
    (also when a check fails)."""

    def __enter__(self) -> str:
        import tempfile

        self.path = tempfile.mkdtemp(prefix="heat_tpu_torch_surface_")
        return self.path

    def __exit__(self, *exc) -> bool:
        import shutil

        shutil.rmtree(self.path, ignore_errors=True)
        return False


def _surface_row(smi: str, **row) -> dict:
    row = {"phase": "surface", **row, "card": smi}
    print(json.dumps(row), flush=True)
    return row


def _wall(fn) -> tuple:
    """(``fn()``, its wall ms, the card synchronised before and after)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _same_on_card(label: str, got, want, split) -> None:
    if not got.larray.is_cuda:
        fail(f"{label}: the result left the card ({got.larray.device})")
    if got.split != split:
        fail(f"{label}: split {got.split}, want {split}")
    import torch

    if got.larray.shape != want.shape or not torch.equal(got.larray, want):
        fail(f"{label}: the round trip is not bit for bit")


def surface_io(ht, smi: str, d: str) -> None:
    """Save and load X = SURF_IO_SHAPE through .npy, zarr and the array
    checkpoint (HDF5 and netCDF where h5py imports), CSV at SURF_CSV_SHAPE,
    the LM of phase 6 with its Adam state, and the corruption fallback."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(160)
    X = torch.randn(SURF_IO_SHAPE, generator=g, device="cuda")
    x = ht.array(X, split=0)
    nbytes = X.numel() * 4
    host, d2h = _wall(lambda: X.cpu())
    _, h2d = _wall(lambda: host.to("cuda"))
    del host
    _surface_row(smi, op="yardstick", shape=list(SURF_IO_SHAPE), bytes=nbytes, d2h_ms=d2h, h2d_ms=h2d,
             d2h_gbs=nbytes / d2h / 1e6, h2d_gbs=nbytes / h2d / 1e6, note="torch's own .cpu() and .to('cuda')")
    formats = [("npy", os.path.join(d, "x.npy"), ()), ("zarr", os.path.join(d, "x.zarr"), ())]
    missing = hdf5_missing()
    if missing is None:
        formats += [("hdf5", os.path.join(d, "x.h5"), ("data",)), ("netcdf", os.path.join(d, "x.nc"), ("data",))]
    else:
        print(json.dumps(missing), flush=True)
    for fmt, path, args in formats:
        _, save_ms = _wall(lambda: ht.save(x, path, *args))
        y, load_ms = _wall(lambda: ht.load(path, *args, split=0))
        _same_on_card(f"io {fmt}", y, X, 0)
        _surface_row(smi, op=f"io {fmt}", shape=list(SURF_IO_SHAPE), save_ms=save_ms, load_ms=load_ms,
                 save_gbs=nbytes / save_ms / 1e6, load_gbs=nbytes / load_ms / 1e6, check="bit for bit, split 0")
        del y
        import shutil

        shutil.rmtree(path, ignore_errors=True) if os.path.isdir(path) else os.remove(path)
    ck = os.path.join(d, "x_ckpt")
    _, save_ms = _wall(lambda: ht.save_array_checkpoint(x, ck))
    y, load_ms = _wall(lambda: ht.load_array_checkpoint(ck))
    _same_on_card("io array checkpoint", y, X, 0)
    _surface_row(smi, op="io array checkpoint", shape=list(SURF_IO_SHAPE), save_ms=save_ms, load_ms=load_ms,
             save_gbs=nbytes / save_ms / 1e6, load_gbs=nbytes / load_ms / 1e6, check="bit for bit, split 0")
    del y, x, X
    import shutil

    shutil.rmtree(ck, ignore_errors=True)
    torch.cuda.empty_cache()
    C = torch.randn(SURF_CSV_SHAPE, generator=g, device="cuda")
    path = os.path.join(d, "c.csv")
    _, save_ms = _wall(lambda: ht.save(ht.array(C, split=0), path))
    y, load_ms = _wall(lambda: ht.load(path, split=0))
    _same_on_card("io csv", y, C, 0)
    _surface_row(smi, op="io csv", shape=list(SURF_CSV_SHAPE), save_ms=save_ms, load_ms=load_ms,
             file_bytes=os.path.getsize(path), check="bit for bit (9 significant digits), split 0")
    os.remove(path)
    # the corruption fallback: the newest version's chunk flipped, the previous one loads
    ck = os.path.join(d, "c_ckpt")
    ht.save_array_checkpoint(ht.array(C, split=0), ck, keep_versions=2)
    ht.save_array_checkpoint(ht.array(C + 1, split=0), ck, keep_versions=2)
    chunk = os.path.join(ck, "v1", "chunk_0.npy")
    with open(chunk, "r+b") as fh:
        fh.seek(-4, 2)
        b = fh.read(1)
        fh.seek(-4, 2)
        fh.write(bytes([b[0] ^ 0xFF]))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        y = ht.load_array_checkpoint(ck)
    if not any("falling back to v0" in str(m.message) for m in w):
        fail("the corrupted checkpoint version was not refused")
    _same_on_card("io checkpoint fallback", y, C, 0)
    _surface_row(smi, op="io checkpoint fallback", shape=list(SURF_CSV_SHAPE), check="v1 refused (crc32), v0 loaded")
    del y, C
    shutil.rmtree(ck, ignore_errors=True)
    # the LM of phase 6 with its Adam state (a pytree checkpoint)
    torch.manual_seed(161)
    lm = ht.nn.models.TransformerLM(**LM)
    opt = torch.optim.Adam(lm.parameters(), lr=LM_LR)
    tokens = torch.randint(0, LM["vocab_size"], (2, 65), device="cuda")
    lm_loss(ht, lm, tokens).backward()
    opt.step()
    tree = {"model": lm.state_dict(), "opt": opt.state_dict()}
    n_params = sum(p.numel() for p in lm.parameters())
    path = os.path.join(d, "lm.npz")
    _, save_ms = _wall(lambda: ht.save_checkpoint(tree, path))
    back, load_ms = _wall(lambda: ht.load_checkpoint(tree, path))
    for key, v in tree["model"].items():
        if not torch.equal(back["model"][key], v) or not back["model"][key].is_cuda:
            fail(f"LM checkpoint: {key} differs or left the card")
    for i, st in tree["opt"]["state"].items():
        for key, v in st.items():
            if not torch.equal(back["opt"]["state"][i][key].to(v.device), v):
                fail(f"LM checkpoint: optimizer state {i}.{key} differs")
    _surface_row(smi, op="io pytree checkpoint (TransformerLM + Adam)", parameters=n_params,
             file_bytes=os.path.getsize(path), save_ms=save_ms, load_ms=load_ms, check="every tensor bit for bit")
    os.remove(path)
    del lm, opt, tree, back
    torch.cuda.empty_cache()


def surface_fft(ht, smi: str) -> None:
    """fft2, rfft2 and ifft2 of SURF_FFT_N^2 split 0 beside torch.fft's own
    call, and a SURF_FFT_CHECK^2 slice against complex128."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(162)
    n = SURF_FFT_N
    R = torch.randn(n, n, generator=g, device="cuda")
    for name, inp in (("fft2", "complex"), ("ifft2", "complex"), ("rfft2", "real")):
        T = torch.complex(R, R.flip(0)) if inp == "complex" else R
        x = ht.array(T, split=0)
        fn = getattr(ht.fft, name)
        tfn = getattr(torch.fft, name)
        got, _ = _wall(lambda: fn(x))
        if not got.larray.is_cuda or got.split != 0:
            fail(f"fft {name}: split {got.split} on {got.larray.device}")
        if not torch.equal(got.larray, tfn(T)):
            fail(f"fft {name}: not torch.fft's own result")
        del got
        ms = cuda_ms(lambda: fn(x), 3)
        torch_ms = cuda_ms(lambda: tfn(T), 3)
        item = T.element_size()
        out_item = 8
        bound, by = stats_bound_ms(n * n * item, n * n * out_item * (0.5 if name == "rfft2" else 1.0))
        s = SURF_FFT_CHECK
        small = T[:s, :s].contiguous()
        want = tfn(small.to(torch.complex128 if inp == "complex" else torch.float64))
        sub = fn(ht.array(small, split=0)).larray
        err = float((sub.to(torch.complex128) - want).abs().max() / want.abs().max())
        if not err <= SURF_RTOL:
            fail(f"fft {name}: {err} of the largest entry from complex128")
        _surface_row(smi, op=f"fft {name}", shape=[n, n], dtype=str(T.dtype), split=0, ms=ms, torch_ms=torch_ms,
                 bound_ms=bound, bound_by=by, max_rel_err_vs_complex128=err, check_shape=[s, s])
        del x, T
        torch.cuda.empty_cache()
    del R
    torch.cuda.empty_cache()


def surface_convolve(ht, smi: str) -> None:
    """A SURF_CONV_N-sample float32 signal with a SURF_CONV_M-tap filter in
    each mode, timed beside conv1d's own call and the 2nm bound, held
    against float64 on a SURF_CONV_CHECK piece: IEEE float32, not TF32."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(163)
    n, m = SURF_CONV_N, SURF_CONV_M
    A = torch.randn(n, generator=g, device="cuda")
    V = torch.randn(m, generator=g, device="cuda")
    a, v = ht.array(A, split=0), ht.array(V)
    piece = A[:SURF_CONV_CHECK]
    # the piece's full convolution in float64, once: the big run's leading
    # rows depend on the piece alone
    g64 = F.conv1d(piece.double()[None, None], V.double().flip(0)[None, None], padding=m - 1)[0, 0]
    for mode in ("full", "same", "valid"):
        got, _ = _wall(lambda: ht.convolve(a, v, mode=mode))
        if not got.larray.is_cuda or got.split != 0 or got.dtype is not ht.float32:
            fail(f"convolve {mode}: {got.dtype}, split {got.split} on {got.larray.device}")
        want_len = {"full": n + m - 1, "same": n, "valid": n - m + 1}[mode]
        if got.shape != (want_len,):
            fail(f"convolve {mode}: shape {got.shape}")
        # the first rows of the result, and the piece's own convolution,
        # against float64 on the card
        off = {"full": 0, "same": (m - 1) // 2, "valid": m - 1}[mode]
        k = SURF_CONV_CHECK - off
        err = float((got.larray[:k].double() - g64[off:off + k]).abs().max() / g64[off:off + k].abs().max())
        small = ht.convolve(ht.array(piece, split=0), v, mode=mode).larray
        want = g64[off:off + {"full": SURF_CONV_CHECK + m - 1, "same": SURF_CONV_CHECK,
                              "valid": SURF_CONV_CHECK - m + 1}[mode]]
        err_small = float((small.double() - want).abs().max() / want.abs().max())
        if not (err <= SURF_CONV_RTOL and err_small <= SURF_CONV_RTOL):
            fail(f"convolve {mode}: {err} / {err_small} of the largest float64 entry (TF32 would be ~1e-3)")
        del got
        ms = cuda_ms(lambda: ht.convolve(a, v, mode=mode), 2)
        pad = {"full": m - 1, "same": (m - 1) // 2, "valid": 0}[mode]

        def conv1d_call():
            from heat_tpu_torch.linalg.basics import _full_float32

            with _full_float32():
                return F.conv1d(A[None, None], V.flip(0)[None, None], padding=pad) if mode != "same" else \
                    F.conv1d(A[None, None], V.flip(0)[None, None], padding="same")

        conv_ms = cuda_ms(conv1d_call, 2)
        bound, by = conv_bound_ms(n, m)
        _surface_row(smi, op=f"convolve {mode}", n=n, m=m, split=0, ms=ms, conv1d_ms=conv_ms, bound_ms=bound,
                 bound_by=by, tflops=2.0 * n * m / ms / 1e9, max_rel_err_vs_float64=max(err, err_small),
                 check=f"IEEE float32: within {SURF_CONV_RTOL} of float64 on {SURF_CONV_CHECK} samples")
        torch.cuda.empty_cache()
    del a, A
    torch.cuda.empty_cache()


def surface_sparse(ht, smi: str) -> None:
    """A SURF_SPARSE_N^2 CSR of SURF_SPARSE_ROW nonzeros a row times a dense
    (SURF_SPARSE_N, SURF_SPARSE_K), beside torch.sparse.mm and the bytes
    bound, SURF_SPARSE_CHECK rows against float64; add, mul, transpose and
    todense at SURF_SMALL_N^2, 1% dense."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(164)
    n, r, k = SURF_SPARSE_N, SURF_SPARSE_ROW, SURF_SPARSE_K
    nnz = n * r
    cols = torch.randint(0, n, (n, r), generator=g, device="cuda").sort(1).values.reshape(-1)
    vals = torch.randn(nnz, generator=g, device="cuda")
    crow = torch.arange(0, nnz + 1, r, device="cuda", dtype=torch.int64)
    csr = torch.sparse_csr_tensor(crow, cols, vals, size=(n, n))
    s = ht.sparse.sparse_csr_matrix(csr, split=0)
    D = torch.randn(n, k, generator=g, device="cuda")
    dd = ht.array(D)
    got, _ = _wall(lambda: s @ dd)
    if not got.larray.is_cuda or got.split != 0:
        fail(f"sparse matmul: split {got.split} on {got.larray.device}")
    c = SURF_SPARSE_CHECK
    want = (vals[:c * r].double()[:, None] * D.double()[cols[:c * r]]).reshape(c, r, k).sum(1)
    err = float((got.larray[:c].double() - want).abs().max() / want.abs().max())
    if not err <= SURF_RTOL:
        fail(f"sparse matmul: {err} of the largest float64 entry")
    del got
    ms = cuda_ms(lambda: s @ dd, 3)
    torch_ms = cuda_ms(lambda: torch.sparse.mm(csr, D), 3)
    bound, by = spmm_bound_ms(n, nnz, k, n)
    _surface_row(smi, op="sparse matmul", shape=[n, n], nnz=nnz, k=k, split=0, ms=ms, torch_sparse_mm_ms=torch_ms,
             bound_ms=bound, bound_by=by, bytes=spmm_bytes(n, nnz, k, n), max_rel_err_vs_float64=err,
             check_rows=c)
    del s, csr, cols, vals, D, dd
    torch.cuda.empty_cache()
    m = SURF_SMALL_N
    M = torch.randn(m, m, generator=g, device="cuda")
    M = M * (torch.rand(m, m, generator=g, device="cuda") < SURF_SMALL_DENSITY)
    a = ht.sparse.sparse_csr_matrix(M.to_sparse_csr(), split=0)
    for name, fn, want_fn in (("add", lambda: a + a, lambda: M + M), ("mul", lambda: a * a, lambda: M * M),
                              ("transpose", lambda: ht.sparse.transpose(a), lambda: M.T),
                              ("todense", lambda: a, lambda: M)):
        res, _ = _wall(fn)
        dense = res.todense()
        if not dense.larray.is_cuda or not torch.equal(dense.larray, want_fn()):
            fail(f"sparse {name}: differs from the dense result or left the card")
        ms = cuda_ms(lambda: fn().todense() if name == "todense" else fn(), 3)
        _surface_row(smi, op=f"sparse {name}", shape=[m, m], nnz=a.gnnz, ms=ms, check="bit for bit the dense op")
        del res, dense
    del a, M
    torch.cuda.empty_cache()


def surface_vmap(ht, smi: str) -> None:
    import torch

    g = torch.Generator(device="cuda").manual_seed(165)
    X = torch.randn(SURF_VMAP_SHAPE, generator=g, device="cuda")
    x = ht.array(X, split=0)
    fn = ht.vmap(lambda r: ht.exp(r) * 2.0 - ht.sum(r))
    got, ms = _wall(lambda: fn(x))
    want = torch.exp(X) * 2.0 - X.sum(1, keepdim=True)
    err = float((got.larray - want).abs().max() / want.abs().max())
    if not got.larray.is_cuda or got.split != 0 or not err <= SURF_RTOL:
        fail(f"vmap: {err}, split {got.split} on {got.larray.device}")
    _surface_row(smi, op="vmap", shape=list(SURF_VMAP_SHAPE), ms=ms, max_rel_err_vs_whole=err,
             check="the function applied to the whole array")


def surface_world_one(ht, smi: str) -> float:
    """Phase 3g at world size 1; prints each part's seconds and returns the sum."""
    t0 = time.perf_counter()
    with scratch_dir() as d:
        surface_io(ht, smi, d)
    parts = {"io": time.perf_counter() - t0}
    for name, fn in (("fft", surface_fft), ("convolve", surface_convolve), ("sparse", surface_sparse), ("vmap", surface_vmap)):
        t1 = time.perf_counter()
        fn(ht, smi)
        parts[name] = time.perf_counter() - t1
    seconds = time.perf_counter() - t0
    _surface_row(smi, op="world one seconds", parts=parts, seconds=seconds)
    return seconds


def _daso_steps(ht, comm, ckpt: str, interrupt: bool) -> list:
    """Five DASO steps of a small MLP on this rank's rows (2 groups of 1,
    warmup 1, skip 2, one stale step); with ``interrupt`` it checkpoints at
    step 3 and a fresh DASO resumes.  Returns each step's loss and the
    parameters after the last two."""
    import numpy as np
    import torch

    rng = np.random.default_rng(7 + comm.rank)
    xs = [torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32)).cuda() for _ in range(5)]
    ys = [torch.from_numpy(rng.integers(0, 4, 16)).cuda() for _ in range(5)]

    def build(seed):
        torch.manual_seed(seed)
        model = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.ReLU(), torch.nn.Linear(64, 4)).cuda()
        daso = ht.optim.DASO(ht.optim.DataParallelOptimizer("adam", lr=0.01), total_local_comm_size=1,
                             warmup_steps=1, global_skip=2, stale_steps=1,
                             checkpoint_every=3 if interrupt else None, checkpoint_dir=ckpt)
        daso.init(model)
        return daso

    daso, out = build(3), []
    for t in range(5):
        if interrupt and t == 3:
            daso = build(99)
            if not daso.resume():
                raise RuntimeError("DASO found no checkpoint to resume")
        out.append(float(daso.step(torch.nn.functional.cross_entropy, xs[t], ys[t])))
        if t >= 3:
            out += torch.cat([p.detach().reshape(-1) for p in daso.parameters]).cpu().tolist()
    return out


def surface_cases(ht, d: str) -> dict:
    """The 2-rank cases of phase 3g, each as {name: numpy array}: every
    format's save and load, an array checkpoint (left in ``d`` for world
    size 1 to read), convolutions (one with chunks shorter than the halo),
    fft along the split axis, the sparse product and ring_map."""
    import numpy as np
    import torch

    g = torch.Generator(device="cuda").manual_seed(166)
    X = torch.randn(20_003, 32, generator=g, device="cuda")
    out = {}
    formats = [("npy", "x.npy", ()), ("csv", "x.csv", ()), ("zarr", "x.zarr", ())]
    if hdf5_missing() is None:
        formats += [("hdf5", "x.h5", ("data",)), ("netcdf", "x.nc", ("data",))]
    for fmt, name, args in formats:
        for split in (0, 1):
            path = os.path.join(d, f"{split}_{name}")
            ht.save(ht.array(X, split=split), path, *args)
            y = ht.load(path, *args, split=split)
            if not y.larray.is_cuda or y.split != split:
                raise RuntimeError(f"{fmt}: split {y.split} on {y.larray.device}")
            out[f"io {fmt} split {split}"] = y.numpy()
    ht.save_array_checkpoint(ht.array(X, split=0), os.path.join(d, "ckpt_2r"))
    out["array checkpoint"] = ht.load_array_checkpoint(os.path.join(d, "ckpt_2r")).numpy()
    sig = torch.randn(SURF_2R_SIG, generator=g, device="cuda")
    ker = torch.randn(SURF_2R_KER, generator=g, device="cuda")
    long = torch.randn(SURF_2R_LONG, generator=g, device="cuda")
    lker = torch.randn(SURF_2R_LONG_KER, generator=g, device="cuda")
    for mode in ("full", "same", "valid"):
        out[f"convolve short {mode}"] = ht.convolve(ht.array(sig, split=0), ht.array(ker), mode=mode).numpy()
        out[f"convolve long {mode}"] = ht.convolve(ht.array(long, split=0), ht.array(lker), mode=mode).numpy()
    C = torch.complex(torch.randn(4097, 256, generator=g, device="cuda"),
                      torch.randn(4097, 256, generator=g, device="cuda"))
    out["fft along the split axis"] = ht.fft.fft(ht.array(C, split=0), axis=0).numpy()
    out["fft2 split 1"] = ht.fft.fft2(ht.array(C, split=1)).numpy()
    n = 100_001
    cols = torch.randint(0, n, (n, 8), generator=g, device="cuda").sort(1).values.reshape(-1)
    csr = torch.sparse_csr_tensor(torch.arange(0, 8 * n + 1, 8, device="cuda"), cols,
                                  torch.randn(8 * n, generator=g, device="cuda"), size=(n, n))
    dense = torch.randn(n, 16, generator=g, device="cuda")
    out["sparse matmul"] = (ht.sparse.sparse_csr_matrix(csr, split=0) @ ht.array(dense, split=1)).numpy()
    x = ht.array(X[:1025, :8].contiguous(), split=0)
    out["ring_map concat"] = ht.parallel.ring_map(lambda a, b, src: a @ b.T, x, x).numpy()
    out["ring_map sum"] = ht.parallel.ring_map(lambda a, b, src: a * b.sum(0), x, x, combine="sum").numpy()
    return {k: np.asarray(v) for k, v in out.items()}


def surface_rank(ht, rank: int, d: str) -> dict:
    """A rank's part of ``two_rank_world``: ``surface_cases`` and the DASO
    checkpoint and resume."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    comm = ht.core.communication.get_comm()
    res = {"cases": surface_cases(ht, d)}
    res["daso"] = [_daso_steps(ht, comm, os.path.join(d, "daso_plain"), False),
                   _daso_steps(ht, comm, os.path.join(d, "daso_resumed"), True)]
    return res


def surface_two_ranks(ht, smi: str, results: dict, part_s: float, r2: str) -> float:
    """Phase 3g's 2-rank part: ``surface_rank``'s ``surface_cases`` on 2
    spawned ranks on this card over gloo (``results``, ``part_s`` seconds on
    rank 0, written under ``r2``) against world size 1 (exact for I/O, else
    within SURF_RTOL of the largest entry); the array checkpoint the ranks
    wrote read here at world size 1; DASO's next 2 steps after a resume bit
    for bit the uninterrupted run's.  Returns its seconds."""
    import numpy as np

    t0 = time.perf_counter()
    with scratch_dir() as d:
        w1 = os.path.join(d, "w1")
        os.makedirs(w1)
        want = surface_cases(ht, w1)
        for rank, res in sorted(results.items()):
            for name, w in want.items():
                got = res["cases"].get(name)
                if got is None or got.shape != w.shape:
                    fail(f"rank {rank}: {name} has shape {None if got is None else got.shape}, want {w.shape}")
                exact = name.startswith(("io", "array"))
                err = float(np.abs(got - w).max()) / max(float(np.abs(w).max()), 1e-30) if w.size else 0.0
                if (exact and not np.array_equal(got, w)) or err > SURF_RTOL:
                    fail(f"rank {rank}: {name} differs from world size 1 ({err} of the largest entry)")
            plain, resumed = res["daso"]
            if plain != resumed:
                fail(f"rank {rank}: DASO's steps after the resume differ from the uninterrupted run's")
        back = ht.load_array_checkpoint(os.path.join(r2, "ckpt_2r"))
        if not back.larray.is_cuda or not np.array_equal(back.numpy(), want["array checkpoint"]):
            fail("the array checkpoint written at 2 ranks does not load at world size 1")
    seconds = part_s + time.perf_counter() - t0
    _surface_row(smi, op="two ranks", note="2 processes on ONE card over gloo, against world size 1",
             cases=len(want), daso="checkpoint at step 3, resumed: steps 4 and 5 bit for bit", seconds=seconds)
    return seconds


def check_serving_kernels(spec: dict) -> None:
    """assign and em_stats at the shapes the serving phase's KMeans jobs
    give them: the job ``spec``'s own two-blob points (as
    ``parallel.serving`` makes them) at world size 1, and each rank's half
    at 2 ranks (d = 2, k = 2), with one point of each blob as the centres,
    as a random initialisation draws them; against their plain versions
    (compare_assign, compare_em)."""
    import numpy as np
    import torch

    from heat_tpu_torch.ops import kmeans_kernels as kk

    n, seed = int(spec["payload"]["n"]), int(spec["payload"]["seed"])
    pts = np.random.default_rng(seed).standard_normal((n, 2)).astype(np.float32)
    pts[: n // 2] += 8.0
    x_all = torch.from_numpy(pts).cuda()
    c = x_all[[0, n - 1]].contiguous()
    half = (n + 1) // 2  # the first rank's rows: Communication.chunk's rule
    for where, x in (("world size 1", x_all), ("rank 0 of 2", x_all[:half]), ("rank 1 of 2", x_all[half:])):
        x = x.contiguous()
        lab, d2 = kk.fused_assign(x, c)
        sums, counts = kk.fused_em_stats(x, c)
        lab_p, d2_p = kk._torch_assign(x, c)
        sums_p, counts_p = kk._torch_em_stats(x, c, x.shape[0])
        torch.cuda.synchronize()
        mism, near, d2_err = compare_assign(x, c, lab, d2, lab_p, d2_p)
        err, exact = compare_em(x, c, x.shape[0], sums, counts, lab, sums_p, counts_p, mism)
        print(json.dumps({"phase": "kernel_check", "kernel": "assign+em_stats", "serving": where,
                          "rows": x.shape[0], "k": 2, "d": 2, "dtype": "float32",
                          "route": kk.launch_config(2, 2, x.dtype)["route"], "assign_max_abs_err": d2_err,
                          "label_mismatches": mism, "near_ties": near, "max_abs_err": err,
                          "max_abs_err_vs_float64": exact, "check": "pass"}), flush=True)


def serving_phase(smi: str) -> dict:
    """Phase 14: SERVE_JOBS jobs offered to the supervised 2-rank world, one
    rank killed at its SERVE_KILL dispatch, against the DONE jobs at world
    size 1 in this process (``parallel.serve_world``; see the docstring)."""
    import shutil

    from heat_tpu_torch.parallel import scheduler
    from heat_tpu_torch.parallel import serve_world as sw

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_serve")
    shutil.rmtree(work, ignore_errors=True)
    jobs = sw.job_stream(SERVE_JOBS, **SERVE_SIZES)
    check_serving_kernels(next(j for j in jobs if j["kind"] == "kmeans"))
    served = sw.serve_supervised(jobs, 2, work, device="gpu", kill=SERVE_KILL, heartbeat_timeout=300.0,
                                 generation_deadline=600.0)
    views = scheduler.replay_journal(served["journal"])["jobs"]
    t0 = time.perf_counter()
    local = sw.serve_local([j for j in jobs if views.get(j["id"], {}).get("state") == scheduler.DONE], device="gpu")
    world_one_s = time.perf_counter() - t0
    try:
        checked = sw.check_served(served, jobs, local, SERVE_RTOL)
    except AssertionError as e:
        fail(f"serving: {e}")
    metrics = sw.stream_metrics(served, jobs)
    launches = {"assign": 0, "em_stats": 0}
    for w in served["workers"]:
        for key in launches:
            launches[key] += int(w["kmeans_launches"][key])
    if not (launches["assign"] > 0 and launches["em_stats"] > 0):
        fail(f"serving: the KMeans jobs launched {launches}")
    sup = served["supervisor"]
    if sup["restarts"] != 1 or not any("died" in f for f in sup["failures"]):
        fail(f"serving: the killed rank did not restart the world once: {sup['failures']}")
    if checked["summary"]["accepted"] < 64 or checked["summary"]["shed"] != len(jobs) - sw.queue_bound(len(jobs)):
        fail(f"serving: {checked['summary']['accepted']} jobs accepted and {checked['summary']['shed']} shed")
    out = {"phase": "serving", "jobs": len(jobs), "tenants": sorted({j["tenant"] for j in jobs}),
           "sizes": SERVE_SIZES, "kill": SERVE_KILL, "ranks": 2, "transport": "gloo",
           "supervised_seconds": served["seconds"], "world_one_seconds": world_one_s,
           "jobs_per_s": metrics["jobs_per_s"], "latency_s": metrics["latency_s"],
           "recovery_s": metrics["recovery_s"], "kmeans_launches": launches,
           "digest_max_rel_err": checked["digest_max_rel_err"], "digest_rtol": SERVE_RTOL,
           "summary": checked["summary"], "done_by_generation": checked["done_by_generation"],
           "failures": sup["failures"], "card": smi, "check": "pass"}
    print(json.dumps(out), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return out


# phase 15: the chaos scenarios (heat_tpu_torch.chaos.scenarios), each a
# supervised world of the port's ranks on this card over gloo
CHAOS_SCENARIOS = ("kill-resume-train", "serve-sigkill-mid-queue", "hang-straggler-verdict",
                   "desync-minority-verdict", "fed-world-kill")
# the worlds that run at once: the killed ones, then the post-mortem ones (2 + 2 + 2, then 2 + 3 ranks)
CHAOS_WAVES = (("kill-resume-train", "serve-sigkill-mid-queue", "fed-world-kill"),
               ("hang-straggler-verdict", "desync-minority-verdict"))
CHAOS_HB_TIMEOUT_S = 30  # the post-mortem worlds' staleness: a rank on the card comes up in ~10 s
CHAOS_TIMEOUT_S = 420  # a scenario that has not ended by then fails the run (its whole session killed)
# the verdict each post-mortem scenario's supervisor report must carry: rank 1 named
CHAOS_VERDICTS = {"hang-straggler-verdict": lambda v: v["verdict"] == "straggler" and v["straggler"]["rank"] == 1,
                  "desync-minority-verdict": lambda v: v["verdict"] == "desync" and v["deviating_ranks"] == [1]}
CHAOS_LINES = ("SUPERVISOR restarts", "RESUMED", "TRAIN-OK", "SCHED jobs", "SCHED-RECOVERED", "PM-HANG",
               "PM-DESYNC", "POSTMORTEM", "CRITICAL-PATH kind=collective", "FED ", "FED-QUARANTINED", "FED-RESIZE",
               "STEP-OVERLAP")


def _supervisor_report(out: str) -> dict:
    """The supervisor's report a failed world prints after its give-up line."""
    at = out.find("SUPERVISOR GAVE UP; diagnostic report:")
    if at < 0:
        return {}
    start = out.index("{", at)
    return json.JSONDecoder().raw_decode(out[start:])[0]


def chaos_phase(smi: str) -> dict:
    """Phase 15: each of CHAOS_SCENARIOS through ``chaos.scenarios`` with
    every rank on this card (``device="gpu"``, gloo), judged by its spec's
    contract (``check_scenario``); the post-mortem scenarios' supervisor
    reports must carry their verdicts under ``postmortems``.  The scenarios
    run in CHAOS_WAVES, the worlds of a wave at once (each its own ports,
    directories and processes).  Prints each scenario's seconds and its
    attestation lines."""
    from concurrent.futures import ThreadPoolExecutor

    from heat_tpu_torch.chaos import scenarios

    def run(name):
        env = {"MPDRYRUN_HB_TIMEOUT": CHAOS_HB_TIMEOUT_S} if scenarios.scenario(name)["mode"] == "postmortem" else {}
        t0 = time.perf_counter()
        proc = scenarios.run_scenario(name, timeout=CHAOS_TIMEOUT_S, device="gpu", env=env)
        return proc, time.perf_counter() - t0

    seconds, t_phase = {}, time.perf_counter()
    for wave in CHAOS_WAVES:
        with ThreadPoolExecutor(len(wave)) as pool:
            runs = dict(zip(wave, pool.map(run, wave)))
        for name in wave:
            proc, seconds[name] = runs[name]
            spec = scenarios.scenario(name)
            bad = scenarios.check_scenario(name, proc)
            row = {"phase": "chaos", "scenario": name, "mode": spec["mode"], "ranks": spec["n_proc"],
                   "device": "gpu (one card, gloo)", "wave": list(wave), "seconds": seconds[name],
                   "rc": proc.returncode}
            if name in CHAOS_VERDICTS:
                pms = _supervisor_report(proc.stdout).get("postmortems") or []
                row["postmortems"] = [{k: v.get(k) for k in ("verdict", "epoch", "first_divergent_seq",
                                                             "deviating_ranks", "straggler")} for v in pms]
                if not any(CHAOS_VERDICTS[name](v) for v in pms):
                    bad.append(f"the supervisor's report carries no verdict naming rank 1: {row['postmortems']}")
            row["lines"] = [ln for ln in proc.stdout.splitlines()
                            if ln.split("] ", 1)[-1].startswith(CHAOS_LINES)][:24]
            if bad:
                print(proc.stdout[-6000:], proc.stderr[-3000:], sep="\n")
                fail(f"chaos scenario {name}: {bad}")
            print(json.dumps({**row, "check": "pass", "card": smi}), flush=True)
    out = {"phase": "chaos_seconds", "seconds": seconds, "phase_seconds": time.perf_counter() - t_phase, "card": smi}
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    global _TEARDOWN_CUPTI
    import torch

    _TEARDOWN_CUPTI = True
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test needs a GPU", file=sys.stderr)
        return 2
    import heat_tpu_torch as ht
    from heat_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full float32
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    ht.use_device("gpu")

    # 1. card and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": name}), flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "library": _build.build_info["library"]}), flush=True)
    for line in _build.build_info["log"].splitlines():
        if any(word in line for word in ("entry function", "registers", "spill", "error")):
            print("ptxas:", line.strip())
    for kernel, source in {**TC_KERNELS, **F32_KERNELS}.items():
        print(json.dumps({"phase": "ptxas", "kernel": kernel, "source": source,
                          "instances": ptxas_report(_build.build_info["log"], kernel)}), flush=True)
    for kernel, source in WIDE_KERNELS.items():
        print(json.dumps({"phase": "ptxas", "kernel": kernel, "source": source,
                          "instances": wide_ptxas_report(_build.build_info["log"], kernel)}), flush=True)
    for kernel, source in KMEANS_KERNELS.items():
        print(json.dumps({"phase": "ptxas", "kernel": kernel, "source": source,
                          "instances": kmeans_ptxas_report(_build.build_info["log"], kernel)}), flush=True)

    # 2. kernels against their plain versions
    for dtype in (torch.float32, torch.bfloat16):
        check_kernels_small(dtype)
    check_em_edges()
    flash_errs = check_flash_kernels(MHA_KERNELS, FLASH_CHECKS, FLASH_MAIN, FWD_EDGE_CHECKS + WIDE_EDGE_CHECKS,
                                     FLASH_D512)
    gqa_errs = check_flash_kernels(GQA_KERNELS, GQA_CHECKS, GQA_MAIN, GQA_FWD_EDGE_CHECKS, GQA_D512)
    pos_errs = check_pos_kernels()

    # 3. the KMeans main path at full width
    gm = torch.Generator().manual_seed(7)
    means = torch.rand((K, D), generator=gm) * 40.0 - 20.0
    x = ht.utils.data.create_clusters(N_MAIN, D, K, means.numpy(), cluster_std=1.0, device="gpu", random_state=0)
    km, launches, _ = main_fit(ht, x, "float32")
    means_dev = means.cuda()
    print(json.dumps({"phase": "main_path_recovery", "fit": "float32", "init": "random",
                      "means_within_tol": recovered(km.cluster_centers_.larray.float(), means_dev, RECOVER_TOL),
                      "tol": RECOVER_TOL, "held": False}), flush=True)
    # near-tie rows, where the two paths' float32 expansions round apart,
    # move a centre by ~1e-3 in one step at this size
    compare_with_torch_path(ht, x, km, "float32", atol=2e-2, rtol=1e-4)
    recover(ht, x, means_dev, "float32_kmeans++")

    rows = time_kernels(x.larray, km._centers, launches, check_at_main_shape(x.larray, km._centers, "float32"))
    launch = kmeans_launch(x.larray, km._centers)
    for row in rows:
        row.update(launch[row["name"]])

    xb = ht.utils.data.create_clusters(N_MAIN, D, K, means.numpy(), cluster_std=1.0, device="gpu",
                                       random_state=0, dtype=ht.bfloat16)
    del x
    kb, launches_bf16, _ = main_fit(ht, xb, "bfloat16")
    compare_with_torch_path(ht, xb, kb, "bfloat16", atol=2e-2, rtol=2.0**-7)  # plus one bfloat16 ulp
    errs = check_at_main_shape(xb.larray, kb._centers, "bfloat16")
    launch_bf16 = kmeans_launch(xb.larray, kb._centers)
    for row, bf in zip(rows, time_kernels(xb.larray, kb._centers, launches_bf16, errs)):
        row["bfloat16"] = {key: bf[key] for key in ("launches", "max_abs_err", "max_abs_err_vs_float64", "ms",
                                                     "plain_ms", "bound_ms", "bound_by", "library_ms", "check")}
        row["bfloat16"].update(launch_bf16[row["name"]])
    del xb

    xp = ht.utils.data.create_clusters(N_PLUSPLUS, D, K, means.numpy(), cluster_std=1.0, device="gpu",
                                       random_state=1)
    recover(ht, xp, means_dev, "float32_kmeans++_2^22")
    del xp
    torch.cuda.empty_cache()
    for row, streamed in zip(rows, (lambda t: [t["assign"], t["em_stats"]])(time_kmeans_streamed())):
        row.update(streamed)

    # Every phase in this process that reads the profiler runs before the
    # first spawned rank: after ranks on the card exit, its sessions mostly
    # record nothing (``profiled``).
    # 3b. the array core's indexing at the sizes users index, world size 1
    # (X of config 2's shape, A of config 0's)
    indexing_world_one(ht, smi)

    # 4. ht.matmul (BASELINE config 0): world size 1 at 4096^2 and 16384^2
    matmul_world_one(ht, smi)

    # 4b. tall-skinny QR/SVD (BASELINE config 1) at 1e6 x 256, the solvers,
    # cdist at 32768^2 x 32, world size 1
    t0 = time.perf_counter()
    qr_main(ht, smi)
    cdist_main(ht, smi)
    linalg_s = time.perf_counter() - t0

    # 4c. data-parallel training: config 3's MLP and config 4's ResNet-50 at
    # world size 1
    t0 = time.perf_counter()
    config3_world_one(ht, smi)
    config4_world_one(ht, smi)
    torch.cuda.empty_cache()
    data_parallel_s = time.perf_counter() - t0

    # 6. the LMs, multi-head and grouped-query: training, one step against
    # the plain versions, generation
    launches, peaks = {}, {}
    for cfg, kernels, label in ((LM, MHA_KERNELS, "TransformerLM"),
                                (LM_GQA, GQA_KERNELS, "TransformerLM(num_kv_heads=2, rope)")):
        lm, opt, counts, batch = lm_train(ht, cfg, kernels, f"{label} training")
        peaks[label] = torch.cuda.max_memory_allocated()  # the training's peak, as its main_path line prints
        launches.update({key: counts[key] for key in kernels})
        profile_training_step(ht, lm, opt, batch, f"{label} training")
        lm_step_vs_plain(ht, lm, batch, kernels, label)
        lm_generate(ht, lm, kernels[0], f"{label} generation")
        del lm, opt, batch
        torch.cuda.empty_cache()
    # the multi-head LM trained in bfloat16: every bfloat16 kernel on the tensor cores
    launches_bf16 = lm_train_bf16(ht)
    # one step of an LM of head dim 512: the wide route on the training path
    lm_d512_step(ht)
    # 11b. the rest of the nn surface at world size 1: Seq2SeqTransformer at
    # transformer-base width, the MoE LM, remat, the layer families
    nn_s = nn_surface_world_one(ht, smi, peaks["TransformerLM"])

    # 12. the kernels' timings; the positions kernels' launches come from 10
    rows += flash_rows(MHA_KERNELS, FLASH_MAIN, (132, 339, 376), launches, flash_errs, bench=FLASH_BENCH,
                       launches_bf16=launches_bf16, wide=FLASH_WIDE, d512=FLASH_D512)
    rows += flash_rows(GQA_KERNELS, GQA_MAIN, (871, 924, 945), launches, gqa_errs, wide=GQA_WIDE, d512=GQA_D512)
    pos = pos_rows(pos_errs)
    torch.cuda.empty_cache()

    # 3e. the estimators at world size 1 at users' sizes (their launch counts
    # read the profiler: before the first spawned rank)
    estimators_world_one(ht, smi)
    torch.cuda.empty_cache()

    # 10. the sequence-parallel LM over 2 ranks on this card, the first
    # spawned ranks
    t0 = time.perf_counter()
    ring = ring_train(smi)
    print(json.dumps({"phase": "nn_surface_seconds", "world_one": nn_s,
                      "ring_phase_with_two_rank_part": time.perf_counter() - t0, "card": smi}), flush=True)
    for row in pos:
        row["launches"] = ring[row["name"]]
    rows += pos

    # 3c. the random streams, statistics, manipulations and the sort at
    # world size 1 at users' sizes; 3g. I/O, fft, convolve, sparse and vmap
    # at world size 1
    stats_world_one(ht, smi)
    surface_s = surface_world_one(ht, smi)

    # 3b, 4, 4b, 4c, 3d (the sort), 3f (the tiled resplit and the
    # estimators) and 3g (with ring_map and DASO's resume) on 2 ranks on
    # this card: one spawned world for all of them
    two_rank_s = two_rank_phases(ht, smi)
    print(json.dumps({"phase": "linalg_seconds", "seconds": linalg_s + two_rank_s["linalg"]}), flush=True)
    print(json.dumps({"phase": "data_parallel_seconds", "seconds": data_parallel_s + two_rank_s["data_parallel"]}),
          flush=True)
    print(json.dumps({"phase": "surface_seconds", "seconds": surface_s + two_rank_s["surface"], "card": smi}),
          flush=True)

    # 14. the serving tier: 2 supervised gloo ranks on this card, one killed,
    # against world size 1
    serving_phase(smi)

    # 15. the chaos scenarios: supervised worlds of the port's ranks on
    # this card, killed, hung or desynchronised, each judged by its spec
    chaos_phase(smi)

    # 16. the kernels line and the result
    print(json.dumps({"phase": "script_seconds", "seconds": time.perf_counter() - t_script, "card": smi}), flush=True)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except BaseException:
        traceback.print_exc()
        code = 1
    # a process whose profiler finalized CUPTI can hang in the
    # interpreter's exit (seen on an H100), so the script leaves at once;
    # every rank it spawned has been joined
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
