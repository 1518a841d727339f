#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``grandtpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the result line:

1. device: CUDA present; the card's name and power limit (nvidia-smi);
2. build: nvcc builds every kernel of ``grandtpu_torch/csrc`` for sm_90a;
3. kernels vs their plain PyTorch versions on the card, at reddit width
   (K1 DropNode gather-mean: features [233000, 602], cols/vals [250, 64],
   K = 2 with masks at 0.5, the eval form [1230, 64] and the 2-shard mesh's
   shard form [125, 64], each the same bits on a second call, with its
   device time beside CUDA events', ``F.embedding_bag``'s and its bound
   (the distinct rows of the slots some mask keeps); K2 CSR SpMM: 6
   ppr hops on the operator of ``synth:233000:41:602``), with max relative
   error <= 1e-5 (f32 sums in another order) and kernel / plain / library
   times and each kernel's bound;
3a. the Adam kernel (``csrc/adam.cu``, grandtpu's optax chain as one
    launch over a list of leaves) bit for bit its plain version at the
    reddit MLP's leaves and at the MAG table [2780000, 64] with its head,
    at the preset's weight decay and at 1e-3, one launch a call; its
    device time beside CUDA events', the plain version's,
    ``torch.optim.Adam(fused=True)``'s (the library call) and the foreach
    Adam's, and its bound (28 bytes an element with a gradient). Every
    training path below checks Adam's launches: once a step (a mesh's
    leaves on the one card take one launch);
3e. GFPush on the card, with the reddit preset's push (ppr, order 6, alpha
    0.05, rmax 1e-5, k 64) from the 12,050 sources ``train()`` builds:
    ``gfpush(backend="jax")`` (P1: the push mask, K2 over A^T at [233000,
    512], the top-k) and ``gfpush(backend="bucket")`` (P2: ``bucket_hop``
    a hop, ``bucket_reserve`` a block, top-k), each a path of its own
    (counts set to 0 before, read after), each held to the native push
    under the row rule of tests/test_gfpush_backends.py (atol = tie_tol =
    max(1e-5, 2 rmax)), to its plain version on the card (P2 bit for bit,
    its sums being fixed point; P1 cols equal and vals <= 1e-5, K2 adding
    in edge order), and to a second run (identical; P2's peak device
    memory); on the first block (1,024 sources, or the block the push's
    back-off settled on) every ``bucket_hop`` bit
    for bit the plain hop from the same frontier (each source's next
    frontier ordered by id, cnt, exp) and ``bucket_reserve`` bit for bit
    the plain reserve table (ids ordered, u64 sums, f32 values), with each
    hop's share of sources on the global table, the kernels' shared bytes,
    registers and CTAs an SM; push_topk bit for bit its plain version at
    P1's form [512, 233000], at 4 of its rows made all positive (past the
    kernel's shared buffer) and at P2's form; kernel / plain / library
    (``torch.topk``) times and bounds (P2's kernels by their device time,
    with the wrapper's call time beside it; P2's hop also with its random
    record reads counted as 32-byte sectors, and its global tables'
    traffic apart), and sources/s beside native's with the host's cores;
4. reference on a small input: ``train()`` with DropNode off on
   ``synth:2000:8:64`` on the card and on the CPU (plain versions) gives
   the same validation history (|d val_loss| <= 1e-4) and test accuracy
   within one node;
4d. the same with ``push_backend="bucket"`` (P2 on the card, its plain
    version on the CPU);
5. main path: ``train()`` with the reddit preset on
   ``synth:233000:41:602`` for 2 epochs, launch counters set to 0 just
   before; losses finite, K1 launched for every step and eval, K2 exactly
   ``order`` times;
6. profile: the main path once more under torch.profiler, device time by
   kernel and the device's busy share (after the counters were read).
5g. (after 5) the long-run options of the reddit path: ``train()`` with
    the reddit preset on ``synth:233000:41:602`` at full width in a child
    process, with ``ckpt_dir``, ``save_every=1``, ``metrics_path``,
    ``push_cache_dir`` and ``profile_dir``; once the first eval line is in
    the metrics file the parent sends SIGTERM, and the child must stop at a
    group end, write ``latest.npz`` (the next step's index), log
    ``preempted`` and exit 0 with ``preempted`` true. Then ``train(...,
    resume=True)`` here, a path (counts set to 0 before): its first eval
    after the saved index, the push a cache hit (no push kernel, no native
    push; cols and vals the child's bit for bit), the metrics file with
    eval lines, ``preempted`` and ``train_end`` (``train_edges_per_s`` >
    0), the trace in ``profile_dir`` naming K2's kernel, K2 exactly
    ``order`` launches; preprocess times and test accuracy beside the
    child's and phase 5's.
5g-dir. (after 5g) the same with ``ckpt_backend="orbax"``, the port's
    directory checkpoints (``best/``, ``latest/``: the npz's flat dict
    through torch.distributed.checkpoint): the child, on 5g's push cache,
    stops itself at 5g's stop step; both are directories; the resume here
    is a path, its history, test_acc and parameter digest 5g's resumed
    run's bit for bit; each form's save seconds a call and bytes on disk.
5h. (after 5g) ``scan_steps``: ``train()`` with the reddit preset on
    ``synth:233000:41:602`` for 10 epochs, per step (twice: the second
    run's differences are the runs' own spread) and then with
    ``scan_steps`` (the same seeds), each a path: grandtpu's policy rolls
    the length-10 groups (6 of them, 60 of the 170 steps), each a CUDA
    graph replay; the same step count, the validation history bit for bit
    the per-step run's and the same test_acc (a replayed step runs the
    same launches as an eager one, Adam's bias corrections taken from its
    count on the card), K1 and Adam launched once a step (K1 also once an
    eval) in every run (a replay adds the
    launches its capture took back); each run's host batch_time_median,
    its synchronized seconds a step and peak memory. Then, from one saved
    state (model, BN buffers, Adam, generator) at full width with every
    drop rate of the step on, one captured group of 10 steps against the
    same 10 steps run eagerly: bit for bit, the generator's state and
    Adam's count too (advanced by 10 a replay); the wrappers' counts after
    the capture's first and second replay; the group's synchronized time
    against the eager steps'.
    After 5b the same for the MAG engine (mag_scholar_c, 10 epochs:
    lengths 3 and 7 roll, 20 of 80 steps; the history bit for bit and the
    same test_acc; K3's forward and backward and Adam once a step; a group
    of 7 bit for bit its eager steps, K3's backward adding in a fixed
    order), with the graph pools' memory against the per-step run's
    peak.

Then the same for the MAG (sparse-feature) engine, on
``synth:1000000:8:2780000:sparse`` (vocabulary 2,780,000, P = 24):

3c. K3 embed_prop forward and backward vs their plain versions (autograd
    for the backward) at the ``mag_scholar_c`` shapes: table
    [2780000, 64], attr tables [1000000, 24]; the train form (R = 40,
    Ktop = 32, K = 2) without and with a q = 0.5 input-dropout mask, the
    eval form (K = 1, the 240 val rows) and the node form on a
    10,000-node chunk; max relative error <= 1e-5 (the backward adds in
    another order than autograd); the backward also against
    ``embed_prop_backward_plain`` (<= 1e-5; it adds in the kernels' order,
    so it also reports whether the bits are equal); each forward form's
    kernel also timed on the device alone (torch.profiler over 100 calls)
    beside its wrapper time, and the backward's device time as the sum of
    every device operation of one call (its four kernels; no sort may
    run) beside autograd's wall (host dispatch included), its bound also
    with the backward's own scratch traffic, ``embedding_bag`` autograd's
    wall and device time beside it (and the same on the [2780000, 32]
    column blocks, with their bounds); the node form over
    all nodes as the predict runs it (CUDA events and the kernels' device
    time); K2 timed at H = 64 on the MAG operator;
4b. reference on a small input: ``train()`` with the mag_scholar_c
    preset, every drop rate 0, on ``synth:2000:8:500:sparse`` on the card
    and on the CPU: |d val_loss| <= 1e-4 at every eval, test accuracy
    within one node;
5b. MAG main path: ``train()`` with the mag_scholar_c preset, 5 epochs
    (40 steps, 4 evals, then embed -> 10 K2 hops -> head over all 1M
    nodes), counters set to 0 just before; losses finite, the K3 forward
    launched for every step, eval and predict chunk, the K3 backward once
    per step, K2 exactly ``order`` times;
5i. (after 5b) the MAG path for 1 epoch with ``save_every=1`` and
    ``ckpt_backend="orbax"``, a path: ``latest/`` holds the [2780000, 64]
    table with Adam's ``mu`` and ``nu`` (2.1 GB), restored bit for bit
    the trees the loop saved; the same trees as ``latest.npz`` bit for bit
    the directory's; save and load seconds and bytes on disk of both;
6b. profile of the MAG main path, with the Adam kernel's device time a
    launch against the device time a step.

Then the fast-precision predict, with the Amazon2M preset (F = 100,
hidden 1024, 47 classes, ppr order 6, alpha 0.2) on
``synth:2000000:47:100`` (2M nodes, 8,885,478 nonzeros with self-loops):

3d. K1 against its plain version at the Amazon2M path's shapes (its
    features [2000000, 100], cols/vals [250, 64], K = 2, and the eval form
    [1410, 64]), <= 1e-5, timed as in 3; K2 (f32) for 6 ppr hops against
    its plain version, <= 1e-5; K2-bf16 (f32 and bf16 carries), quantize, K2-q8 and
    K2-q8mxu against their plain versions at the Amazon2M shape
    [2000000, 100], 6 ppr hops each, one hop at a time on a shared input
    (both take the plain hop's output): quantize's q equal element for
    element, K2-q8mxu <= 1e-6 (int32 sums are exact), K2-bf16 with f32
    carries and K2-q8 <= 1e-5, bf16 carries bit for bit (the plain
    versions add in the kernels' order); each whole 6-hop run against the
    f32 K2 result: <= 5e-3 (bf16, int8, int8cast, the fast-path gate) and
    <= 2e-2 (bf16_carry); K2-q8 and K2-q8mxu also with bf16 carries, 6
    hops one at a time, bit for bit; kernel / plain / library times and
    bounds, and for K2-q8 and K2-q8mxu the configuration their kernel
    picked, the device time beside the CUDA events' and the floor their
    gathers set (nnz rows of q, as bytes and as 32-byte sectors), and the
    int8 hop's two streams alone: its carries (``torch.add``) and its
    gathers of q's rows (``index_select``), each with its rate. The int8
    hops also raise their column maxima (``amax_out``), each hop's held bit
    for bit to ``column_absmax`` of the y it stored, and every hop's
    quantize but the first runs as the one launch of
    ``quantize_with_amax`` on those maxima, bit for bit the plain
    quantize; quantize is timed in both forms (the first hop's full
    ``quantize_columns``, the later hops' ``quantize_with_amax``), the
    int8 hops with and without ``amax_out``, and the whole int8 and
    int8cast 6-hop runs;
7.  precision sweep, on the operators 3d built: ``order`` hops timed for
    f32, bf16, int8 (K2-q8mxu), int8cast (K2-q8) and bf16 carries, each
    with its error against f32 and its peak memory; then ``calibrate()``
    with its default candidates. Every hop kernel must have launched on
    this path;
4c. reference on a small input: ``exact_propagate(backend="csr")`` for
    every precision on ``synth:30000:8:64`` (above the dense threshold) on
    the card and on the CPU (<= 1e-5 f32, <= 5e-3 fast forms, <= 2e-2
    bf16_carry), then ``train()`` with the Amazon2M preset, every drop rate
    0 and ``predict_precision="auto"``: |d val_loss| <= 1e-4 at every
    eval, test accuracy within one node;
5c. main path: ``train()`` with the Amazon2M preset, 2 epochs,
    ``predict_precision="auto"`` (which resolves to int8, so K2-q8mxu),
    counters set to 0 just before; losses finite, K1 launched for every
    step and eval, K2-q8mxu exactly ``order`` times, ``quantize_columns``
    once (the first hop) and ``quantize_with_amax`` ``order - 1`` times,
    the f32 K2 not at all;
6c. profile of the Amazon2M main path;
3f. (after 7) P2 as in 3e with the Amazon2M preset's push (rmax 1e-6, the
    deepest of the presets) from the 12,350 sources of its ``train()``,
    against native, its plain version and a second run; its kernels' times
    at these shapes are the kernels line's;
5d. the Amazon2M ``train()`` of 5c with ``push_backend="bucket"`` and a
    checkpoint directory: the P2 kernels and the top-k launch, the 5c
    checks hold, preprocess_time printed beside 5c's (native);
3g. (after 7, on 3d's graph) K2-seg: 6 fused ppr hops of
    ``spmm_segment_prop_step`` (one launch a hop, the update in its
    epilogue) against its plain version, one at a time on a shared input
    (rows under the split cap bit for bit, all rows <= 1e-5), and the
    bare product ``spmm_segment`` bit for bit; the
    ``Propagator(backend="segment")`` run as a path (K2-seg exactly
    ``order`` launches, nothing else) against the csr backend's f32 run
    (<= 1e-5), its peak device memory against the csr run's; the fused
    hop's, the bare product's and the whole run's times, the hop's plain
    time, the library's (``torch.sparse.mm`` on the coalesced COO, A x
    only) and the bounds (the fused hop: 12 e_pad + 16 n F bytes); then
    K2-seg's bf16-carry form (grandtpu's segment hop on bf16 carries: f32
    terms summed in f32, each row rounded to bf16 once, the update in
    bf16): 6 fused hops on bf16 carries against its plain version, every
    element bit for bit (the largest difference printed in bf16 ulps;
    3j holds its split hub rows the same way), the
    ``exact_propagator(backend="segment", precision="bf16_carry")`` run
    as a path (K2-seg exactly ``order`` launches, nothing else), its error
    against the csr f32 run beside the 2e-2 bf16_carry gate, its time
    beside the f32 segment run's and the csr bf16_carry run's, its peak
    memory beside the f32 segment run's, and the hop's time, plain time,
    library time (bf16 COO, if this torch takes it) and bound (12 e_pad +
    8 n F bytes; with its gathers, nnz rows of x at 2 F bytes, beside);
8.  D1, row-partitioned propagation on a 4-shard mesh on the one card
    (``make_mesh(4, devices=[cuda:0] * 4)``): ``dist_exact_propagate``
    all_gather in f32, bf16 and int8 and halo (``halo_threshold=1.0``) in
    f32 and int8, and ``sharded_propagate`` (K2-seg, one fused launch a
    shard and hop) in f32, each a path of its own with exact launch
    counts (order x 4 of its hop kernel, and of ``quantize_with_amax``,
    ``halo_pack`` and the halo's ``column_absmax`` where the form runs
    them; the all_gather int8 run's ``column_absmax`` once a shard, at its
    first hop), each against its own plain run on the card (<= 1e-5 f32
    and bf16 terms, 5e-3 int8) and against the one-card ``Propagator`` at
    the same precision (f32 <= 1e-5; the fast forms within the 5e-3 gate
    of f32); then the halo kernels', the quantize split's and the
    collectives' times at the shard shapes (halo_pack through the
    propagator's send plan, also on the device alone), and the halo
    compression;
8m. (after 8) D1 on the (2 x 2) mesh of the card (``make_mesh(2,
    n_model=2, devices=[cuda:0] * 4)``), sharded along 'data' (all_gather
    f32 and int8, halo int8, scatter f32: each model column a replica)
    and along 'model' (all_gather f32, halo f32: each data row a
    replica), each a path of its own with phase 8's launch counts on all
    4 shards, every group's result equal, held to its plain run at phase
    8's limits and bit for bit to the same form on a 1-D mesh of 2 shards
    of the card; build and hop seconds and the bound beside phase 8's,
    and the device memory the operators hold;
5e. the slice's main path, serving: ``python -m grandtpu_torch.cli.main
    predict --preset Amazon2M --dataset synth:2000000:47:100 --ckpt
    <5d's best.npz>`` (run in this process through ``cli()``, its counts
    read around it) with ``--precision f32`` and ``auto``: its test
    accuracy equals that of the 5d model at the same precision (auto:
    5d's own), its npz holds [2000000, 47] logits, its hop kernels launch
    ``order`` times; the wall time split into data, checkpoint, operator
    build, hops and classify. Then the same checkpoint as a directory
    (its flat dict the npz's, key for key) served at f32: the logits the
    npz's bit for bit.

3j. (after 3i) hub rows: grandtpu/bench/skew_probe.py's skew graph
    (the ``synth`` SBM base, 300,000 nodes, degree 20, with self-loops,
    plus 200 hub rows of 15,000 random neighbours, F 128), whose operator
    splits the hub rows into chunks: one hop of K2, K2-bf16 and K2-bf16
    with bf16 carries against their plain versions (which follow the same
    plan; <= 1e-5, bf16 carries bit for bit); one hop of K2-q8 and of
    K2-q8mxu, split and unsplit (a cap above the longest row), each bit
    for bit its plain version on the same q, and K2-q8mxu's split hop bit
    for bit its unsplit one (int32 sums); whole 5-hop ppr runs at f32,
    bf16, int8 (K2-q8mxu) and int8cast (K2-q8) as one path (each hop
    kernel exactly 5 launches, quantize_columns 2 and quantize_with_amax
    8) against their plain runs
    (<= 1e-5), each run's error against the f32 run printed beside the
    5e-3 gate (reported, not gated); the split hops' times beside the
    unsplit hops' (K2, K2-bf16, K2-q8, K2-q8mxu) and quantize's, the
    plain, ``torch.sparse.mm`` (K2) and the bounds, the gathered bytes
    (for K2-q8 and K2-q8mxu also the configuration, device time and
    sectors, as in 3d), one fused K2-seg hop on the skew graph's operator
    as row-sorted COO, split by its own plan, against its plain version
    (rows under the cap bit for bit, <= 1e-5) with its time,
    the split rows and chunks, the host seconds of the graph, the
    operator and the plan.
3k. (after 3j) P2 on 3j's skew graph with the Amazon2M preset's push (ppr
    order 6, alpha 0.2, rmax 1e-6, k 64) from 1,024 sources: the first 512
    by id of the nodes whose rows hold a hub, then 512 others drawn with
    RandomState(0); checked as in 3e (path with its launches, native
    under the row rule, plain version bit for bit, two runs, each kernel
    bit for bit), and the largest hop must put sources on the global
    table (a hub's 15,000 slots are over the shared table's 6,144);
5f. (after 5e) the slice's path, serving a power-law graph from its
    files: 5d's in-memory ``synth:2000000:47:100`` plus 200 hub rows of
    4,096 random neighbours (skew_probe's construction, RandomState(7),
    re-binarised, no self-loops), above the operator's split cap (512)
    and below the int8 hub guard (8,192), written in the Amazon2M file
    layout (``Amazon2M_adj.npz`` uncompressed, ``Amazon2M_feat.npy``,
    ``Amazon2M_labels.npy`` as class ids) to a temporary directory that
    is removed at the end; with ``GRANDTPU_DATA_DIR`` pointing there,
    ``train()`` with the Amazon2M preset (full width, 1 epoch, ``auto``,
    a checkpoint directory) as a path: it loads the files, ``auto``
    resolves to int8, K2-q8mxu launches ``order`` times and quantize as
    in 5c,
    every K2-q8mxu hop on a split plan; then ``python -m
    grandtpu_torch.cli.main predict --preset Amazon2M --ckpt <its
    best.npz>`` at f32, int8 and auto, each in a child process with its
    launch counts (each a path: ``order`` launches of its hop kernels, the
    int8 ones on a split plan), each int8 predict's test accuracy within
    2e-3 of the f32 predict's and auto's equal to ``train()``'s; the
    int8 propagation's error against f32 (reported beside the 5e-3 gate),
    one split K2-q8mxu hop on the loaded graph's operator bit for bit its
    plain version and the unsplit hop, the split and unsplit K2-q8mxu hop
    times on the loaded graph (the split hop's configuration, device time,
    bound and gathers' floor as in 3d), and
    ``data_s`` from the files beside the 11.25 s that generating the
    graph took in ``predict`` on an H100 80GB HBM3 at 700 W.

Every K2 time is printed beside the bytes its gathers read (nnz rows of
x) at the HBM rate, the floor of a gathering kernel when the L2 catches no
reuse; every K2-q8 and K2-q8mxu time beside that floor for the rows of q,
in bytes and in the 32-byte sectors they touch.

Data-parallel training (D2) on meshes of the one card:

3i. (after 3e) ``sharded_gfpush`` on ``make_mesh(4, devices=[cuda:0] *
    4)`` over 3e's 12,050 sources, a path of its own: P1's mask, K2 and
    top-k launched exactly per shard and block, held to 3e's one-card P1
    under the row rule (max(1e-5, 2 rmax)); sources/s beside 3e's P1;
3m. (after 3i; 8m's push, run where 3e's tables are) ``sharded_gfpush``
    on the (2 x 2) mesh of the card along 'data' and along 'model', each a
    path as 3i's (every group pushes every source), each equal element
    for element to the push on ``make_mesh(2, devices=[cuda:0] * 2)``;
9.  (after 6) the dense engine on ``make_mesh(2, devices=[cuda:0] * 2)``:
    one step of the reddit preset (every drop rate on) against one one-card
    step from the same state and generator seed (metrics, gradients, Adam
    moments and BN buffers within 1e-5 of their tensors' largest element,
    parameter values of the model's largest), both steps' times and the
    bytes the collectives would move between cards; then ``train(cfg,
    mesh=...)`` for 2 epochs as a path: K1 once a shard per step and eval,
    D1's K2 ``order`` x 2 times, nothing else; test accuracy beside 5's;
9t. (after 9) tensor parallelism: the reddit step with the MLP's hidden
    width split over 'model' on ``make_mesh(2, n_model=2, devices=[cuda:0]
    * 4)`` (fcs[0] column-parallel [256, 602] blocks, fcs[1] row-parallel),
    a path of its own: 3 steps (every drop rate on), then the eval of 1,230
    rows, against the one-card steps and eval from the same state and
    generator seed (metrics, parameters, gradients, BN buffers and Adam
    moments within 1e-5, the blocks joined), K1 exactly once a data row a
    step and eval (the model shards of a row share it); then 20
    synchronized steps each of the split mesh, phase 9's 2-shard mesh and
    the one card;
3h. (after 3c) K3's vocab-window forms (``embed_prop_window`` forward and
    backward) on the 4 windows of the 2.78M-word table at the MAG step's
    shapes (every row of the batch over each window), against their plain
    versions (<= 1e-5), the windows' forwards summed against the full K3 and
    their gradients joined against the full backward (<= 1e-5), the padding
    rows' gradient zero, each window's backward against
    ``embed_prop_backward_plain``; kernel / plain / library
    (``F.embedding_bag`` over the window) times and bounds, the forward's
    kernel and every device operation of the backward (and of the
    library's backward) on the device;
9b. (after 6b) the slice's main path, the MAG engine on
    ``make_mesh(4, devices=[cuda:0] * 4)``: one step against the one-card
    step as in 9 (hidden dropout on), then ``train(cfg, mesh=...)`` for 5
    epochs as a path: the K3 window forms 4 times a step, the full K3 4
    times an eval and once per predict chunk, D1's K2 ``order`` x 4 times,
    nothing else; the gathered table's padding rows zero; peak device
    memory beside 5b's.
9tb. (after 9b) the same for the MAG step with the table's columns split
    over 'model' (each model shard a [2780000, 32] block, K3's train form
    over it; the head's first fc row-parallel; input dropout on, each
    shard its columns of the mask): K3's forward exactly once a shard a
    step and eval, its backward once a shard a step; times against 9b's
    4-shard vocab-sharded mesh and the one card; the model state and a
    step's peak device memory against the vocab-sharded step's.

Meshes over processes (``torch.distributed``), on the one card:

9p. (after 9b) 2 ranks, each a process of its own (this script with
    ``--rank``) with the gloo backend on cuda:0 and a free TCP port; the
    parent waits on both with a timeout, and a rank that fails or times
    out fails the run. Each rank first tries each collective of gloo on a
    card tensor once and reports which this torch takes (the mesh stages
    card tensors through pinned host memory for all of them). Then, at
    full width: reddit on ``synth:233000:41:602`` with ``num_devices`` 2
    (one shard a rank): one step against the one-process 2-shard mesh's
    (phase 9's) on the same inputs and seeds (loss and parameters within
    1e-5), its synchronized time and the transport's seconds in it;
    ``train()`` for 2 epochs with a checkpoint directory as a path (each
    rank's launches its own shard's share: K1 once a step and eval, D1's
    hops ``order`` times), every rank's parameters bit for bit the same
    (a digest), the same validation history, test_acc within one node of
    phase 9's, ``best.npz`` written by rank 0 alone; the same run with
    ``ckpt_backend="orbax"``, a path of its own: every rank takes part in
    each save of ``best/`` (each writes its ``.distcp``, sizes printed),
    the history and digest the npz run's, and ``best/`` restored in the
    parent bit for bit the npz run's ``best.npz`` (the same for MAG below,
    both runs with a checkpoint directory); D1 over the ranks on
    the reddit operator (all_gather and halo, f32 within 1e-5 of the
    one-card ``exact_propagate``, int8 within 1e-3 of the one-process
    mesh's int8 run, exact launches, the default threshold 0.5), then
    the all_gather f32 and int8 runs on a (2 x 2) mesh along 'data' (two
    shards a rank, the model columns spanning the ranks) and a (1 x 2)
    mesh along 'model' (the data row spanning them), each rank's result
    from every local group bit for bit the 1-D run's, with its launches
    and the transport's calls and seconds;
    ``multihost_native_gfpush`` of the reddit sources, cols and vals equal
    to the native push of one process; MAG on
    ``synth:1000000:8:2780000:sparse`` with ``num_devices`` 4 (2 ranks x
    2 shards, the table vocab-sharded): the same checks against 9b; last
    the nccl backend with both ranks on the card, which ``make_mesh``
    refuses, naming gloo. The parent then runs the ``predict`` CLI on one
    card from the ranks' ``best.npz``: test_acc within one node of the
    ranks', and from their ``best/``: the same test_acc. Tensor parallelism over the ranks (after each engine's step):
    the reddit and MAG steps split over 'model' on a (1 x 2) mesh whose
    model shards are the ranks, against the one-process (1 x 2) mesh
    (within 1e-5) and 9t's and 9tb's first loss, the ranks' joined
    parameters bit for bit the same, exact launches (K1, or K3's forward
    and backward, once a step a rank), the transport's calls, bytes and
    seconds a step. It prints each rank's step time beside phases 9's,
    9b's, 9t's and 9tb's, the transport's share, and the phase's wall
    time.

Every path (5, 5b, 5c, 5d, 7) must launch exactly the hop kernels of the
form its predict's hops ran (``TrainResult.predict_precision``), and the
push kernels of its push backend only (none with native); the training
paths launch none of D1's or K2-seg's. It prints one
``{"kernels": [...]}`` line, then, as its last line,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import dataclasses
import hashlib
import io
import itertools
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as tdist
import torch.nn.functional as F

from grandtpu_torch.cli.main import cli
from grandtpu_torch.config import preset
from grandtpu_torch.data import load_data
from grandtpu_torch.data.preprocess import (add_self_loops_adj,
                                            eliminate_self_loops_adj)
from grandtpu_torch.data.synthetic import synthetic_graph
from grandtpu_torch.dist import (ShardedGraph, ShardedPropagator,
                                 default_halo_threshold,
                                 dist_exact_propagator,
                                 estimate_halo_compression, make_mesh,
                                 joined_state, multihost_native_gfpush,
                                 shard_batch, shard_sparse_train_inputs,
                                 shard_train_inputs, sharded_gfpush)
from grandtpu_torch.dist.data_parallel import split_rows
from grandtpu_torch.dist.mesh import TRANSPORT, Mesh, reset_transport
from grandtpu_torch.dist.halo import (halo_hop, halo_hop_plain, halo_pack,
                                      halo_pack_plain)
from grandtpu_torch.infer import Propagator, exact_propagate, test_accuracy
from grandtpu_torch.infer import propagate as propagate_mod
from grandtpu_torch.infer.classify import embed_all_nodes
from grandtpu_torch.nn.dropnode import gather_and_prop, gather_and_prop_plain
from grandtpu_torch.nn.mag_mlp import init_mag_mlp
from grandtpu_torch.nn.mlp import MLPConfig, init_mlp
from grandtpu_torch.nn.sparse_input import (PaddedFeatures, embed_prop,
                                            embed_prop_backward,
                                            embed_prop_backward_plain,
                                            embed_prop_plain,
                                            embed_prop_window,
                                            embed_prop_window_backward)
from grandtpu_torch.ops._build import build, build_dir, load_kernels
from grandtpu_torch.ppr import bucket_push, dense_push, gfpush
from grandtpu_torch.ppr import cache as push_cache
from grandtpu_torch.ppr.coef import build_coef
from grandtpu_torch.ppr.dense_push import (dense_push_mask,
                                           dense_push_mask_plain)
from grandtpu_torch.ppr.native import gfpush_native
from grandtpu_torch.ppr.push_topk import push_topk, push_topk_plain
from grandtpu_torch.sparse.spmm import (CSROperator, PaddedCSR,
                                        Q8HopConfig, SplitPlan, bf16_round,
                                        bf16_ulps,
                                        column_absmax,
                                        column_absmax_plain, quantize_columns,
                                        quantize_columns_plain,
                                        quantize_with_amax,
                                        quantize_with_amax_plain,
                                        spmm_prop_step, spmm_prop_step_bf16,
                                        spmm_prop_step_plain,
                                        spmm_prop_step_q8,
                                        spmm_prop_step_q8_plain,
                                        spmm_prop_step_q8mxu,
                                        spmm_prop_step_q8mxu_plain,
                                        spmm_segment, spmm_segment_plain,
                                        spmm_segment_prop_step,
                                        spmm_segment_prop_step_plain)
from grandtpu_torch.train import loop as loop_mod
from grandtpu_torch.train import train
from grandtpu_torch.train import trainer as trainer_mod
from grandtpu_torch.train.adam import (MAX_LEAVES, adam_update,
                                       adam_update_plain)
from grandtpu_torch.train.checkpoint import (_flatten_with_paths,
                                             _load_directory,
                                             load_checkpoint, model_trees,
                                             save_checkpoint)
from grandtpu_torch.train.step import (StepConfig, build_eval_step,
                                       build_train_step, make_optimizer)
from grandtpu_torch.train.trainer_sparse import build_sparse_steps

DATASET = "synth:233000:41:602"     # RESULTS.md's reddit scale stand-in
SMALL = "synth:2000:8:64"
# K1 at the main path's shapes: N, F, B = 50 + 200, Ktop, K, eval rows
K1_SHAPE = (233000, 602, 250, 64, 2, 1230)
# and at the Amazon2M path's (its features; 47 classes x 30 val rows)
AMAZON_K1_SHAPE = (2000000, 100, 250, 64, 2, 1410)
MAG_DATASET = "synth:1000000:8:2780000:sparse"   # tools/mag_scale_run.py vocab
MAG_SMALL = "synth:2000:8:500:sparse"
# K3 at the MAG main path's shapes: batch rows 20 + 20, Ktop, K, val rows
# (8 classes x 30), predict chunk
K3_SHAPE = (40, 32, 2, 240, 10000)
H_MAG = 64                          # mag_scholar_c hidden width
AMAZON = "synth:2000000:47:100"     # RESULTS.md's Amazon2M stand-in
AMAZON_SMALL = "synth:30000:8:64"   # above the dense threshold
# 3j: grandtpu/bench/skew_probe.py's skew graph (n, degree, hubs, hub
# degree, F) and its ppr order; alpha is the Propagator's default
HUB_GRAPH = (300000, 20, 200, 15000, 128)
HUB_ORDER, HUB_ALPHA = 5, 0.2
# 5f: hub rows and their random neighbours added to the Amazon2M stand-in,
# above its operator's split cap (512) and below INT8_MAX_HUB_DEGREE
FILE_HUBS = (200, 4096)
SHARDS = 4                          # phase 8's mesh, on the one card
DENSE_SHARDS = 2                    # phase 9's mesh (reddit's 50 + 200)
MAG_SHARDS = 4                      # 3h's windows, 9b's mesh (20 + 20)
TP_SHAPE = (2, 2)                   # 9t's and 9tb's (data, model) mesh
TP_STEPS, TP_TIMED = 3, 20          # 9t/9tb: steps held to one card, timed
PEAK_GB: dict = {}                  # peak device memory of each train() path
CKPT_DIR = os.path.join("build", "chip_smoke_ckpt")   # 5d's best.npz
TOL = 1e-5                          # max |kernel - plain| / max |plain|
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12             # f32 outside the tensor cores
DEV = torch.device("cuda", 0)


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one ``fn()`` over ``iters`` back-to-back calls
    (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(DEV)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(DEV)
    return start.elapsed_time(end) / iters


def _device_times(fn, iters: int, kernel: str) -> list:
    """The device time (ms) of each launch of the kernels whose name holds
    ``kernel`` that torch.profiler (device activity only) recorded over
    ``iters`` calls of ``fn()``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(DEV)
    for _retry in range(3):  # the profiler drops records, now and then all
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize(DEV)
        times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and kernel in e.name]
        if times:
            break
    return times


def _device_ms(fn, iters: int, kernel: str, per_call: int = 1):
    """Mean device time a call of the kernels whose name holds ``kernel``,
    over ``iters`` calls of ``fn()`` (:func:`_device_times`), each call
    ``per_call`` launches: the kernel's own time, without the host's
    dispatch that :func:`_time_ms` sees when launches are short. The mean
    is over the launches the profiler recorded (it can drop some records).
    None if it recorded no such kernel."""
    times = _device_times(fn, iters, kernel)
    return sum(times) / len(times) * per_call if times else None


def _call_device_ms(fn, iters: int):
    """(mean device ms of one ``fn()``, {kernel: mean ms a call}) over
    ``iters`` calls: for each device operation the profiler recorded
    (kernels, fills, memsets, copies; one stream, so none overlap), its mean
    time a launch times its launches a call, summed. The profiler can drop
    the records of whole calls, so the launches a call are the recorded
    launches over ``iters``, rounded (at least 1). None if it recorded
    none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(DEV)
    for _retry in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize(DEV)
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    if not events:
        return None, {}
    by_name = {}
    for e in events:
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.removeprefix("void ").split("<")[0].split("(")[0]
        name = name.split("::")[-1].strip()[:60]
        by_name.setdefault(name, []).append(e.time_range.elapsed_us() / 1e3)
    per_call = {k: sum(v) / len(v) * max(1, round(len(v) / iters))
                for k, v in by_name.items()}
    return sum(per_call.values()), per_call


def _sort_ms(fn, iters: int):
    """Device time a call of ``fn()`` spends in ``torch.sort``'s kernels
    (CUB's radix sort passes, or a short row's in-place sort), summed over
    their launches; None if the profiler recorded none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(DEV)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize(DEV)
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "sort" in e.name.lower()]
    return sum(times) / iters if times else None


def _busy_ms(fn):
    """(device busy ms, wall ms) of one ``fn()`` under torch.profiler: the
    summed device time of its kernels, copies and fills (one stream, so
    they do not overlap) against the host's clock."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(DEV)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize(DEV)
        wall = (time.time() - t0) * 1e3
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return busy, wall


def _bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _errors(got: torch.Tensor, want: torch.Tensor):
    abs_err = float((got - want).detach().abs().max())
    return abs_err, abs_err / max(float(want.abs().max()), 1e-30)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return smi


def phase_build() -> None:
    t0 = time.time()
    path = build()
    print(f"[build] {path} in {time.time() - t0:.3f} s", flush=True)
    with open(os.path.join(build_dir(), "nvcc.log")) as f:
        for line in f:
            if line.startswith("==") or "registers" in line or "spill" in line:
                print(f"[build] {line.rstrip()}")


def _k1_bound(nfeat: int, sets) -> tuple:
    """K1's bound over input sets (cols, vals, keep): the distinct rows of
    the slots with a nonzero weight in some mask read once (the kernel
    skips the others), 8 B a slot for cols and vals, K B a slot of mask,
    the output written once; 2 K flops a live slot's feature and a divide
    an output. Returns ((ms, by), MB), each the sets' mean."""
    nbytes = flops = 0.0
    for cols, vals, keep in sets:
        num_aug = 1 if keep is None else keep.shape[0]
        live = vals != 0 if keep is None else (vals != 0) & keep.any(0)
        batch, ktop = cols.shape
        nbytes += (torch.unique(cols[live]).numel() * nfeat * 4
                   + batch * ktop * (8 + (0 if keep is None else num_aug))
                   + num_aug * batch * nfeat * 4)
        flops += num_aug * nfeat * (2 * int(live.sum()) + batch)
    return _bound(nbytes / len(sets), flops / len(sets)), \
        nbytes / len(sets) / 1e6


def check_k1(shape, features=None, tag: str = "K1",
             shards: int = 0) -> dict:
    """K1 against its plain version at ``shape`` (N, F, B, Ktop, K, eval
    rows), gathering from ``features`` [N, F] (random if None), in the
    train and eval forms and, with ``shards``, a mesh shard's form (B /
    shards rows): within TOL, the same bits on a second call; the device
    time (the kernel alone), CUDA events over back-to-back calls (the
    host's dispatch too), the plain version, ``F.embedding_bag`` and the
    bound of each form."""
    n, nfeat, batch, ktop, num_aug, n_eval = shape
    g = torch.Generator(device=DEV).manual_seed(0)
    if features is None:
        features = torch.randn(n, nfeat, generator=g, device=DEV)

    def sets(rows, k):
        # distinct batches in turn, so the timed gathers miss the 50 MB L2
        # as a train step's fresh batch does
        out = []
        for _ in range(8):
            cols = torch.randint(0, n, (rows, ktop), generator=g, device=DEV,
                                 dtype=torch.int32)
            vals = torch.rand(rows, ktop, generator=g, device=DEV)
            keep = None if k == 1 else torch.rand(
                k, rows, ktop, generator=g, device=DEV) < 0.5
            out.append((cols, vals, keep))
        return out

    forms = {"train": sets(batch, num_aug), "eval": sets(n_eval, 1)}
    if shards:
        forms["shard"] = sets(batch // shards, num_aug)
    res = {"name": "dropnode_mean", "route": "cuda",
           "source": "grandtpu_torch/csrc/dropnode_mean.cu",
           "replaces": "grandtpu/nn/dropnode.py:21",
           "shape": f"features [{n},{nfeat}], cols [{batch},{ktop}], "
                    f"K={num_aug}; eval [1,{n_eval},{nfeat}]"
                    + (f"; shard [{num_aug},{batch // shards},{nfeat}]"
                       if shards else "")}
    for form, ss in forms.items():
        pre = "" if form == "train" else f"{form}_"
        got = gather_and_prop(features, *ss[0])
        again = gather_and_prop(features, *ss[0])
        torch.cuda.synchronize(DEV)
        abs_err, rel_err = _errors(got,
                                   gather_and_prop_plain(features, *ss[0]))
        same = bool(torch.equal(got, again))
        if not (rel_err <= TOL and same):
            raise AssertionError(f"{tag} {form}: max_rel_err {rel_err} "
                                 f"(limit {TOL}), same bits {same}")
        cols0, vals0, keep0 = ss[0]
        rows, k = cols0.shape[0], 1 if keep0 is None else keep0.shape[0]
        idx = [c.long().repeat(k, 1) for c, _, _ in ss]
        w = [(v[None] if kp is None else torch.where(kp, v[None], 0.0)
              ).reshape(k * rows, ktop) for _, v, kp in ss]
        den = [x.sum(-1, keepdim=True) + 1e-12 for x in w]
        lib = itertools.cycle(list(zip(idx, w, den)))

        def library():
            i, wi, di = next(lib)
            return F.embedding_bag(i, features, per_sample_weights=wi,
                                   mode="sum") / di

        it = itertools.cycle(ss)
        (bound_ms, bound_by), mb = _k1_bound(nfeat, ss)
        res.update({
            f"{pre}max_abs_err": abs_err, f"{pre}max_rel_err": rel_err,
            f"{pre}same_bits": same,
            f"{pre}device_ms": _device_ms(
                lambda: gather_and_prop(features, *next(it)), 200,
                "dropnode_mean"),
            f"{pre}ms": _time_ms(lambda: gather_and_prop(features, *next(it)),
                                 400),
            f"{pre}plain_ms": _time_ms(
                lambda: gather_and_prop_plain(features, *next(it)), 20),
            f"{pre}library_ms": _time_ms(library, 200),
            f"{pre}bound_ms": bound_ms, f"{pre}bound_by": bound_by,
            f"{pre}bound_mb": mb})
        print(f"[{tag}] {form} [{k},{rows},{nfeat}] max_abs_err {abs_err} "
              f"max_rel_err {rel_err} same bits {same}; device_ms "
              f"{res[pre + 'device_ms']} events ms {res[pre + 'ms']} "
              f"plain_ms {res[pre + 'plain_ms']} library_ms "
              f"{res[pre + 'library_ms']} (F.embedding_bag) bound_ms "
              f"{bound_ms} ({bound_by}, {mb:.1f} MB)", flush=True)
    # the entry's errors: the largest over the forms
    for key in ("max_abs_err", "max_rel_err"):
        res[key] = max(res[f"{p}{key}"] for p in ("", *(
            f"{f}_" for f in forms if f != "train")))
    return res


def _gathers(op, x) -> dict:
    """The bytes a hop's row gathers read if the L2 catches no reuse
    (nnz rows of x), and their time at the HBM rate: the floor of a
    gathering kernel, beside the bound's x read once."""
    nbytes = op.nnz * x.shape[1] * x.element_size()
    return {"gather_bytes": nbytes,
            "gather_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def _int8_floor(op, q, nbytes: float) -> dict:
    """The int8 hops' gathers if the L2 catches no reuse: nnz rows of q as
    bytes (nnz * F) and as the 32-byte sectors those rows touch, and the
    floor they set, the bound's ``nbytes`` with its one read of q replaced
    by the sectors; each at the HBM rate."""
    nfeat = q.shape[1]
    start = (q.data_ptr() + nfeat * torch.arange(
        op.num_cols, dtype=torch.int64, device=q.device)) % 32
    per_row = (start + nfeat + 31) // 32
    sectors = 32 * int(per_row[op.indices.long()].sum())
    floor = nbytes - op.num_cols * nfeat + sectors
    return {"gather_bytes": op.nnz * nfeat,
            "gather_ms": op.nnz * nfeat / HBM_BYTES_PER_S * 1e3,
            "gather_sector_bytes": sectors,
            "gather_sector_ms": sectors / HBM_BYTES_PER_S * 1e3,
            "floor_bytes": floor, "floor_ms": floor / HBM_BYTES_PER_S * 1e3}


def _int8_times(fn, op, q, col_scale, y, acc, nbytes: float) -> dict:
    """An int8 hop's launch configuration (the kernels' own choice for its
    arrays, ``csr_spmm_q8_align`` then ``csr_spmm_q8_config``), its
    kernel's device time, the mean over the launches the profiler recorded
    of 30 calls of ``fn`` (one launch a call; beside the CUDA events' time
    over back-to-back calls, which the caller takes), and its gathers'
    floor."""
    lib = load_kernels()
    align = lib.csr_spmm_q8_align(q.data_ptr(), col_scale.data_ptr(),
                                  y.data_ptr(), acc.data_ptr(),
                                  int(y.dtype == torch.bfloat16))
    cfg = (ctypes.c_int * 5)()
    if lib.csr_spmm_q8_config(q.shape[1], align, cfg) != 0:
        raise AssertionError(f"csr_spmm_q8_config refused F {q.shape[1]}")
    times = _device_times(fn, 30, "q8_hop")
    return {"config": Q8HopConfig(*cfg)._asdict(),
            "device_ms": sum(times) / len(times) if times else None,
            "device_launches_recorded": len(times),
            **_int8_floor(op, q, nbytes)}


def _int8_streams(op, q, acc, y) -> None:
    """The int8 hop's two streams apart, each at its rate: its carries'
    (``torch.add(acc, y, out=acc)``: two [n, F] f32 reads and a write, as
    the hop reads acc and writes acc and y) and its gathers'
    (``index_select`` of q's nnz rows as int32 words, less its writes at
    the carries' rate). F must be a multiple of 4."""
    nbytes = 3 * acc.numel() * acc.element_size()
    ms = _time_ms(lambda: torch.add(acc, y, out=acc), 30)
    rate = nbytes / ms / 1e9
    print(f"[3d] the int8 hop's carries alone (torch.add(acc, y, out=acc), "
          f"{nbytes / 1e9:.3f} GB): {ms} ms = {rate:.3f} TB/s", flush=True)
    rows, idx = q.view(torch.int32), op.indices.long()
    got = torch.empty((idx.numel(), rows.shape[1]), dtype=torch.int32,
                      device=q.device)
    ms = _time_ms(lambda: torch.index_select(rows, 0, idx, out=got), 30)
    gathered = idx.numel() * q.shape[1]
    alone = ms - got.numel() * got.element_size() / rate / 1e9
    print(f"[3d] the int8 hop's gathers alone (index_select of q's "
          f"{idx.numel()} rows, {gathered / 1e9:.3f} GB, as many written): "
          f"{ms} ms; less the writes at the carries' rate {alone} ms = "
          f"{gathered / alone / 1e9:.3f} TB/s gathered", flush=True)


def _int8_line(t: dict) -> str:
    dev = t["device_ms"]
    return (f"config {t['config']}; device_ms {dev} (mean of "
            f"{t['device_launches_recorded']} of 30 launches recorded; events "
            f"ms {t['ms']}); "
            f"gathered {t['gather_bytes'] / 1e9:.3f} GB = {t['gather_ms']} "
            f"ms, as 32-byte sectors {t['gather_sector_bytes'] / 1e9:.3f} GB "
            f"= {t['gather_sector_ms']} ms; floor with the gathers "
            f"{t['floor_bytes'] / 1e9:.3f} GB = {t['floor_ms']} ms; events "
            f"at {t['bound_ms'] / t['ms']:.3f} of the bound, "
            f"{t['floor_ms'] / t['ms']:.3f} of the floor; half the bound "
            f"{'reached' if t['ms'] <= 2 * t['bound_ms'] else 'missed'}")


def _k2_times(op, x, scale: float) -> dict:
    """One hop's ms, plain_ms, library_ms (torch.sparse.mm, A x only),
    bound and gathered bytes on operator ``op`` with input ``x`` [n, F]."""
    n, nnz, nfeat = op.num_rows, op.nnz, x.shape[1]
    y, acc = torch.empty_like(x), torch.zeros_like(x)
    ms = _time_ms(lambda: spmm_prop_step(op, x, y, acc, scale, True), 30)
    plain_ms = _time_ms(
        lambda: spmm_prop_step_plain(op, x, y, acc, scale, True), 5)
    a_csr = torch.sparse_csr_tensor(op.indptr, op.indices, op.values,
                                    size=(n, n))
    library_ms = _time_ms(lambda: torch.sparse.mm(a_csr, x), 30)
    nbytes = 4 * n * nfeat * 4 + 8 * nnz + 4 * (n + 1)
    flops = 2 * nnz * nfeat + 2 * n * nfeat
    bound_ms, bound_by = _bound(nbytes, flops)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            **_gathers(op, x)}


def _k2_line(t: dict) -> str:
    return (f"ms {t['ms']} plain_ms {t['plain_ms']} library_ms "
            f"{t['library_ms']} (torch.sparse.mm, y = A x only; K2 no slower "
            f"{'held' if t['ms'] <= t['library_ms'] else 'missed'}) bound_ms "
            f"{t['bound_ms']} ({t['bound_by']}, {t['bytes'] / 1e9:.3f} GB); "
            f"gathered {t['gather_bytes'] / 1e9:.3f} GB = {t['gather_ms']} "
            f"ms at the HBM rate")


def _k2_hops_error(op, x, cfg):
    """Max errors of ``cfg.order`` ppr hops of K2 against the plain hop."""
    scale = 1.0 - cfg.alpha

    def ppr_hops(step):
        cur_in = cfg.alpha * x
        acc = cur_in.clone()
        cur_out = torch.empty_like(cur_in)
        for _ in range(cfg.order):
            step(op, cur_in, cur_out, acc, scale, True)
            cur_in, cur_out = cur_out, cur_in
        return acc

    got = ppr_hops(spmm_prop_step)
    torch.cuda.synchronize(DEV)
    return _errors(got, ppr_hops(spmm_prop_step_plain))


def check_k2(data) -> dict:
    cfg = preset("reddit")
    op = Propagator(add_self_loops_adj(data.adj), backend="csr",
                    device=DEV).adj_op
    x = torch.as_tensor(data.features, device=DEV)
    n, nnz, nfeat = op.num_rows, op.nnz, x.shape[1]
    abs_err, rel_err = _k2_hops_error(op, x, cfg)
    print(f"[K2] {cfg.order} ppr hops, n {n} nnz {nnz} F {nfeat}: "
          f"max_abs_err {abs_err} max_rel_err {rel_err}", flush=True)
    if not rel_err <= TOL:
        raise AssertionError(f"K2 disagrees with its plain version: "
                             f"{rel_err} > {TOL}")
    t = _k2_times(op, x, 1.0 - cfg.alpha)
    print(f"[K2] per hop: {_k2_line(t)}", flush=True)
    return {"name": "csr_spmm_prop", "route": "cuda",
            "source": "grandtpu_torch/csrc/csr_spmm.cu",
            "replaces": "grandtpu/sparse/spmm.py:431",
            "max_abs_err": abs_err, "max_rel_err": rel_err,
            **{k: v for k, v in t.items() if k != "bytes"},
            "shape": f"x [{n},{nfeat}], nnz {nnz}, per hop"}


def check_k2_mag(data, k2: dict) -> None:
    """K2 in embedding space (H = 64) on the MAG operator; adds its numbers
    to the K2 entry ``k2``."""
    cfg = preset("mag_scholar_c")
    op = Propagator(add_self_loops_adj(data.adj), backend="csr",
                    device=DEV).adj_op
    g = torch.Generator(device=DEV).manual_seed(2)
    x = torch.randn(op.num_rows, cfg.hidden, generator=g, device=DEV)
    abs_err, rel_err = _k2_hops_error(op, x, cfg)
    t = _k2_times(op, x, 1.0 - cfg.alpha)
    print(f"[K2] MAG operator, {cfg.order} ppr hops at H {cfg.hidden}, n "
          f"{op.num_rows} nnz {op.nnz}: max_abs_err {abs_err} max_rel_err "
          f"{rel_err}; per hop {_k2_line(t)}", flush=True)
    if not rel_err <= TOL:
        raise AssertionError(f"K2 (H=64) disagrees with its plain version: "
                             f"{rel_err} > {TOL}")
    k2["max_abs_err"] = max(k2["max_abs_err"], abs_err)
    k2["max_rel_err"] = max(k2["max_rel_err"], rel_err)
    k2["mag"] = {"shape": f"x [{op.num_rows},{cfg.hidden}], nnz {op.nnz}, "
                          "per hop",
                 **{k: v for k, v in t.items() if k != "bytes"}}


ADAM_COUNT = 7       # 3a: the step count the bias corrections are taken at


def _adam_leaves(engine: str, g) -> tuple:
    """(preset, leaves, gradients) of a main-path model at full width: the
    reddit preset's MLP (F 602, 41 classes) or mag_scholar_c's table
    [2780000, 64] and head (8 classes), its parameters cloned as leaves;
    the gradients drawn from ``g``, none for the BatchNorm parameters of a
    model without BatchNorm, as in training."""
    if engine == "dense":
        cfg = preset("reddit")
        nfeat, n_class = K1_SHAPE[1], int(DATASET.split(":")[2])
        init = init_mlp
    else:
        cfg = preset("mag_scholar_c")
        nfeat, n_class = (int(MAG_DATASET.split(":")[i]) for i in (3, 2))
        init = init_mag_mlp
    mcfg = MLPConfig(num_features=nfeat, num_classes=n_class,
                     hidden=cfg.hidden, nlayers=cfg.nlayers,
                     use_bn=cfg.use_bn)
    model = init(mcfg, cfg.seed2, DEV)
    leaves, grads = [], []
    for name, p in model.named_parameters():
        leaves.append(p.detach().clone())
        unused = name.startswith("bns.") and not cfg.use_bn
        grads.append(None if unused else
                     torch.randn(p.shape, generator=g, device=DEV) * 1e-2)
    return cfg, leaves, grads


def check_adam() -> dict:
    """Phase 3a: the Adam kernel (``csrc/adam.cu``, grandtpu's optax
    chain) bit for bit its plain version at the reddit MLP's leaves and at
    the MAG table [2780000, 64] with its head (a BatchNorm leaf without a
    gradient among them), from random moments at step ``ADAM_COUNT``, at
    the preset's weight decay and at 1e-3; launches one a call; the
    kernel's device time and CUDA events' time, the plain version's,
    ``torch.optim.Adam(fused=True)``'s on the same leaves (the library
    call: torch's order of the same function) and the foreach Adam's (the
    port's optimizer before), and the bound (each leaf, gradient and
    moment read once, each leaf and moment written once)."""
    g = torch.Generator(device=DEV).manual_seed(11)
    count = torch.tensor(float(ADAM_COUNT), device=DEV)
    bc = 1 - torch.pow(torch.tensor([0.9, 0.999], device=DEV), count)
    out = {}
    for engine in ("dense", "mag"):
        cfg, leaves, grads = _adam_leaves(engine, g)
        mus = [torch.randn(p.shape, generator=g, device=DEV) * 1e-3
               for p in leaves]
        nus = [torch.rand(p.shape, generator=g, device=DEV) * 1e-5
               for p in leaves]
        n = sum(p.numel() for p in leaves)
        errs = []
        for wd in sorted({cfg.weight_decay, 1e-3}):
            a, b = ([[t.clone() for t in ts] for ts in (leaves, mus, nus)]
                    for _ in range(2))
            before = adam_update.launches
            adam_update(a[0], grads, a[1], a[2], bc[0], bc[1], cfg.lr, wd)
            launched = adam_update.launches - before
            adam_update_plain(b[0], grads, b[1], b[2], bc[0], bc[1], cfg.lr,
                              wd)
            torch.cuda.synchronize(DEV)
            same = all(torch.equal(x, y) for xs, ys in zip(a, b)
                       for x, y in zip(xs, ys))
            err = max(_errors(x, y)[0] for xs, ys in zip(a, b)
                      for x, y in zip(xs, ys))
            errs.append(err)
            print(f"[3a] Adam, {engine} leaves ({len(leaves)} leaves, {n} "
                  f"elements, {sum(gr is None for gr in grads)} without a "
                  f"gradient), lr {cfg.lr}, wd {wd}: bit for bit its plain "
                  f"version {same} (max_abs_err {err}), {launched} launch",
                  flush=True)
            if not same or launched != -(-len(leaves) // MAX_LEAVES):
                raise AssertionError(f"[3a] Adam ({engine}, wd {wd}): bit "
                                     f"for bit {same}, {launched} launches")
            del a, b
        wd = cfg.weight_decay
        args = (leaves, grads, mus, nus, bc[0], bc[1], cfg.lr, wd)
        ms = _device_ms(lambda: adam_update(*args), 20, "adam_kernel")
        events_ms = _time_ms(lambda: adam_update(*args), 20)
        plain_ms = _time_ms(lambda: adam_update_plain(*args), 5)
        lib = {}
        for kind in ("fused", "foreach"):
            params = [torch.nn.Parameter(p.clone()) for p in leaves]
            for q, gr in zip(params, grads):
                q.grad = None if gr is None else gr.clone()
            opt = torch.optim.Adam(params, lr=cfg.lr, weight_decay=wd,
                                   **{kind: True})
            lib[kind] = _time_ms(opt.step, 20)
            del opt, params
        nbytes = sum(4 * p.numel() * (6 if gr is None else 7)
                     for p, gr in zip(leaves, grads))
        bound_ms, bound_by = _bound(nbytes, n * (16 if wd > 0 else 14))
        shape = ("the reddit MLP's leaves" if engine == "dense" else
                 f"the table {list(leaves[0].shape)} and the head")
        out[engine] = {"shape": f"{shape}: {len(leaves)} leaves, {n} "
                                f"elements", "ms": ms,
                       "events_ms": events_ms, "plain_ms": plain_ms,
                       "library_ms": lib["fused"],
                       "foreach_ms": lib["foreach"], "bound_ms": bound_ms,
                       "bound_by": bound_by, "bytes": nbytes,
                       "max_abs_err": max(errs)}
        print(f"[3a] Adam, {shape}: device ms {ms} (CUDA events {events_ms})"
              f"; plain_ms {plain_ms}; library_ms {lib['fused']} "
              f"(torch.optim.Adam(fused=True)); the foreach Adam "
              f"{lib['foreach']} ms; bound_ms {bound_ms} ({bound_by}, "
              f"{nbytes / 1e9:.3f} GB, {100 * bound_ms / ms:.1f} % of it)",
              flush=True)
        del leaves, grads, mus, nus, args
        torch.cuda.empty_cache()
    mag = out["mag"]
    return {"name": "adam", "route": "cuda",
            "source": "grandtpu_torch/csrc/adam.cu",
            "replaces": "grandtpu/train/step.py:45",
            "max_abs_err": max(o["max_abs_err"] for o in out.values()),
            **{k: v for k, v in mag.items() if k not in ("bytes",
                                                          "max_abs_err")},
            "reddit": {k: v for k, v in out["dense"].items()
                       if k not in ("bytes", "max_abs_err")},
            "launches_by_path": {}}


def add_hub_rows(adj, hubs: int, hub_deg: int):
    """grandtpu/bench/skew_probe.py:47-55's hubs: ``hubs`` rows drawn with
    RandomState(7), each joined to ``hub_deg`` random columns (which may
    repeat), then the matrix re-binarised."""
    n = adj.shape[0]
    rs = np.random.RandomState(7)
    hub_rows = np.repeat(rs.choice(n, hubs, replace=False), hub_deg)
    hub_cols = rs.randint(0, n, hub_rows.size)
    adj = (adj + sp.csr_matrix((np.ones(hub_rows.size, np.float32),
                                (hub_rows, hub_cols)), shape=adj.shape)
           ).tocsr()
    adj.data[:] = 1.0
    return adj


def hub_graph():
    """grandtpu/bench/skew_probe.py:47-55 with the port's generator: the
    ``synth`` SBM base (degree 20) with self-loops, plus 200 hub rows of
    15,000 random neighbours, re-binarised; features U[0, 1) from
    RandomState(1) as its build_graph draws them."""
    n, deg, hubs, hub_deg, nfeat = HUB_GRAPH
    base, _, _ = synthetic_graph(num_nodes=n, num_classes=8, num_features=4,
                                 avg_degree=deg, seed=0)
    adj = add_hub_rows(add_self_loops_adj(base), hubs, hub_deg)
    feats = np.random.RandomState(1).rand(n, nfeat).astype(np.float32)
    return adj, feats


def hub_push_sources(adj) -> np.ndarray:
    """3k's 1,024 sources: the first 512 by id of the nodes whose rows hold
    a hub (a row of over half the hub degree), then 512 other nodes drawn
    with RandomState(0)."""
    deg = np.diff(adj.indptr)
    rows = np.repeat(np.arange(adj.shape[0]), deg)
    near = np.unique(rows[deg[adj.indices] > HUB_GRAPH[3] // 2])[:512]
    rest = np.setdiff1d(np.arange(adj.shape[0]), near)
    return np.concatenate([near, np.random.RandomState(0).choice(
        rest, 512, replace=False)]).astype(np.int32)


def check_hub_push() -> dict:
    """Phase 3k: P2 on 3j's skew graph with the Amazon2M preset's push,
    from sources whose tables a hub fills (see :func:`hub_push_sources`):
    the path, native, the plain version and a second run as in 3e, its
    largest hop putting sources on the global table."""
    adj, _ = hub_graph()
    sources = hub_push_sources(adj)
    return check_push_graph(adj, sources, preset("Amazon2M"), "3k",
                            ("bucket",), spill=True)


def check_hub_graph() -> dict:
    """Phase 3j: the K2 family on the skew graph, whose hub rows the
    operator splits: one hop of each form against its plain version (which
    follows the same plan; the int8 forms bit for bit, split and
    unsplit), whole ppr runs at f32, bf16, int8 and int8cast as a path
    against the plain runs, and the split hops' times beside the unsplit
    ones' (the same operator built with a cap above its longest row), the
    bounds, the gathered bytes and ``torch.sparse.mm``'s time."""
    t0 = time.time()
    adj, feats = hub_graph()
    gen_s = time.time() - t0
    t0 = time.time()
    prop = Propagator(adj, backend="csr", device=DEV)
    build_s = time.time() - t0
    op = prop.adj_op
    t0 = time.time()
    SplitPlan.build(op.indptr.cpu().numpy(), op.split_cap, DEV)
    plan_s = time.time() - t0
    plan = op.plan
    if plan is None:
        raise AssertionError("[3j] the skew graph's operator split no row")
    max_deg = int((op.indptr[1:] - op.indptr[:-1]).max())
    whole = CSROperator(op.indptr, op.indices, op.values, op.num_rows,
                        split_cap=max_deg)
    n, nnz, nfeat = op.num_rows, op.nnz, feats.shape[1]
    print(f"[3j] skew graph n {n} nnz {nnz} F {nfeat}, longest row "
          f"{max_deg}: generated in {gen_s:.3f} s, operator (D^-1, CSR, "
          f"plan) built in {build_s:.3f} s, of it the plan {plan_s:.3f} s; "
          f"cap {plan.cap}: {plan.rows.numel()} split rows, "
          f"{plan.num_chunks} chunks", flush=True)
    x = torch.as_tensor(feats, device=DEV)
    x_b = x.to(torch.bfloat16)
    scale = 1.0 - HUB_ALPHA
    forms = {"csr_spmm_prop": (spmm_prop_step, "f32", x, TOL),
             "csr_spmm_prop_bf16": (spmm_prop_step_bf16, "bf16", x, TOL),
             # the plain hop adds in the kernel's order: bit for bit
             "csr_spmm_prop_bf16_carry": (spmm_prop_step_bf16, "bf16", x_b,
                                          0.0)}
    out = {"plan": {"cap": plan.cap, "split_rows": int(plan.rows.numel()),
                    "chunks": plan.num_chunks},
           "host_s": {"generate": gen_s, "operator": build_s,
                      "plan": plan_s}, "hop": {}}
    for name, (fn, term, xin, limit) in forms.items():
        acc0 = xin.flip(0).contiguous()
        out_k, acc_k = torch.empty_like(xin), acc0.clone()
        out_p, acc_p = torch.empty_like(xin), acc0.clone()
        fn(op, xin, out_k, acc_k, scale, True)
        torch.cuda.synchronize(DEV)
        spmm_prop_step_plain(op, xin, out_p, acc_p, scale, True, term)
        err = max(_errors(out_k.float(), out_p.float()),
                  _errors(acc_k.float(), acc_p.float()), key=lambda e: e[1])
        del out_k, acc_k, out_p, acc_p, acc0
        print(f"[3j] {name}: one hop against its plain version max_abs_err "
              f"{err[0]} max_rel_err {err[1]} (limit {limit})", flush=True)
        if not err[1] <= limit:
            raise AssertionError(f"[3j] {name} disagrees with its plain "
                                 f"version: {err[1]} > {limit}")
        out["hop"][name] = {"max_abs_err": err[0], "max_rel_err": err[1]}

    row_val = prop.row_val
    if row_val is None:
        raise AssertionError("[3j] the skew operator's rows are not constant")
    x0 = HUB_ALPHA * x
    # the int8 hops on the plain quantize's q, split and unsplit, each bit
    # for bit its plain version (which groups the terms as the kernel
    # does); K2-q8mxu's split hop bit for bit its unsplit one (int32 sums)
    q, q_scale = quantize_columns_plain(x0)
    int8 = {"csr_spmm_q8": (spmm_prop_step_q8, spmm_prop_step_q8_plain,
                            (q, q_scale)),
            "csr_spmm_q8mxu": (spmm_prop_step_q8mxu,
                               spmm_prop_step_q8mxu_plain,
                               (q, q_scale, row_val))}
    acc0 = x0.flip(0).contiguous()
    for name, (fn, plain_fn, args) in int8.items():
        kernel_out = {}
        for tag, o in (("split", op), ("unsplit", whole)):
            out_k, acc_k = torch.empty_like(x0), acc0.clone()
            out_p, acc_p = torch.empty_like(x0), acc0.clone()
            fn(o, *args, out_k, acc_k, scale, True)
            torch.cuda.synchronize(DEV)
            plain_fn(o, *args, out_p, acc_p, scale, True)
            err = max(_errors(out_k, out_p), _errors(acc_k, acc_p),
                      key=lambda e: e[1])
            differ = int((out_k != out_p).sum()) + int((acc_k != acc_p).sum())
            print(f"[3j] {name} {tag}: one hop against its plain version "
                  f"max_abs_err {err[0]} max_rel_err {err[1]}, elements "
                  f"differing {differ} (limit 0: bit for bit)", flush=True)
            if differ:
                raise AssertionError(f"[3j] {name} {tag} is not bit for bit "
                                     f"its plain version: {differ} differ")
            out["hop"][f"{name}_{tag}"] = {"max_abs_err": err[0],
                                           "max_rel_err": err[1],
                                           "elements_differing": differ}
            kernel_out[tag] = (out_k, acc_k)
            del out_p, acc_p
        same = all(torch.equal(a, b) for a, b in zip(kernel_out["split"],
                                                     kernel_out["unsplit"]))
        print(f"[3j] {name}: split hop bit for bit the unsplit hop {same}"
              + (" (required: int32 sums)" if name == "csr_spmm_q8mxu"
                 else ""), flush=True)
        if name == "csr_spmm_q8mxu" and not same:
            raise AssertionError("[3j] the split K2-q8mxu hop differs from "
                                 "the unsplit one")
        del kernel_out
    del acc0

    kw = dict(mode="ppr", order=HUB_ORDER, alpha=HUB_ALPHA)
    _reset_counts()
    runs = {"f32": prop(x, **kw), "bf16": prop(x, precision="bf16", **kw),
            "int8": prop(x, precision="int8", **kw),
            "int8cast": prop(x, precision="int8cast", **kw)}
    launches = _read_counts()
    # two int8 runs: one full quantize each, then HUB_ORDER - 1 on the
    # maxima of the hop before
    want = {"csr_spmm_prop": HUB_ORDER, "csr_spmm_prop_bf16": HUB_ORDER,
            "quantize_columns": 2, "quantize_with_amax": 2 * (HUB_ORDER - 1),
            "csr_spmm_q8mxu": HUB_ORDER, "csr_spmm_q8": HUB_ORDER}
    bad = {k: v for k, v in launches.items() if v != want.get(k, 0)}
    if bad:
        raise AssertionError(f"[3j] ppr runs launched {bad}, want {want}")
    out["launches"] = launches
    out["run"] = {}
    plain_hops = {
        "f32": (lambda ci, co, ac: spmm_prop_step_plain(
            op, ci, co, ac, scale, True, "f32"), False),
        "bf16": (lambda ci, co, ac: spmm_prop_step_plain(
            op, ci, co, ac, scale, True, "bf16"), False),
        "int8": (lambda q_, s_, co, ac: spmm_prop_step_q8mxu_plain(
            op, q_, s_, row_val, co, ac, scale, True), True),
        "int8cast": (lambda q_, s_, co, ac: spmm_prop_step_q8_plain(
            op, q_, s_, co, ac, scale, True), True)}
    for term, got in runs.items():
        plain_hop, quantize = plain_hops[term]
        plain = _plain_ppr_run(plain_hop, x0, HUB_ORDER, quantize)
        err = _errors(got, plain)
        differ = int((got != plain).sum())
        vs_f32 = _errors(got, runs["f32"])[1]
        print(f"[3j] whole {HUB_ORDER}-hop ppr run, {term}, as a path "
              f"(launches {want}): against the plain run max_abs_err "
              f"{err[0]} max_rel_err {err[1]} (limit {TOL}), elements "
              f"differing {differ}; against the f32 run max_rel_err "
              f"{vs_f32} (fast-path gate 5e-3, reported: "
              f"{'within' if vs_f32 <= 5e-3 else 'over'})", flush=True)
        if not err[1] <= TOL:
            raise AssertionError(f"[3j] {term} run disagrees with its plain "
                                 f"run: {err[1]} > {TOL}")
        out["run"][term] = {"max_abs_err": err[0], "max_rel_err": err[1],
                            "elements_differing": differ,
                            "rel_err_vs_f32": vs_f32}
    del runs, plain

    y, acc = torch.empty_like(x), torch.zeros_like(x)
    ms = {}
    for tag, o in (("split", op), ("unsplit", whole)):
        for term, fn in (("f32", spmm_prop_step),
                         ("bf16", spmm_prop_step_bf16)):
            ms[f"{tag}_{term}"] = _time_ms(
                lambda o=o, fn=fn: fn(o, x, y, acc, scale, True), 30)
    plain_ms = _time_ms(
        lambda: spmm_prop_step_plain(op, x, y, acc, scale, True), 3, warmup=1)
    a_csr = torch.sparse_csr_tensor(op.indptr, op.indices, op.values,
                                    size=(n, n))
    library_ms = _time_ms(lambda: torch.sparse.mm(a_csr, x), 30)
    nbytes = 4 * n * nfeat * 4 + 8 * nnz + 4 * (n + 1)
    bound_ms, bound_by = _bound(nbytes, 2 * nnz * nfeat + 2 * n * nfeat)
    gathers = _gathers(op, x)
    print(f"[3j] per hop at [{n},{nfeat}], nnz {nnz}: K2 split ms "
          f"{ms['split_f32']} unsplit ms {ms['unsplit_f32']}; K2-bf16 split "
          f"ms {ms['split_bf16']} unsplit ms {ms['unsplit_bf16']}; plain_ms "
          f"{plain_ms} library_ms {library_ms} (torch.sparse.mm) bound_ms "
          f"{bound_ms} ({bound_by}, {nbytes / 1e9:.3f} GB); gathered "
          f"{gathers['gather_bytes'] / 1e9:.3f} GB = {gathers['gather_ms']} "
          f"ms at the HBM rate; split faster than unsplit "
          f"{'held' if ms['split_f32'] < ms['unsplit_f32'] else 'missed'}, "
          f"than torch.sparse.mm "
          f"{'held' if ms['split_f32'] < library_ms else 'missed'}",
          flush=True)
    out.update(shape=f"skew graph x [{n},{nfeat}], nnz {nnz}, per hop",
               ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by, **gathers)
    out["int8"] = _hub_int8_times(op, whole, x0, q, q_scale, row_val, scale)
    out["segment"] = _hub_segment(op, x0, scale)
    return out


def _hub_segment(op, x0, scale: float) -> dict:
    """3j's K2-seg form: the skew operator as row-sorted COO (its split
    plan from the row counts, as the segment backend builds it), one fused
    hop against its plain version (bit for bit on the rows under the cap,
    <= TOL on the split ones), and its time beside its bound."""
    n, nfeat = op.num_rows, x0.shape[1]
    deg = op.indptr[1:] - op.indptr[:-1]
    rows = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=DEV), deg.long())
    padded = PaddedCSR(rows, op.indices, op.values, n, chunk=1,
                       row_counts=deg.cpu().numpy())
    plan = padded.plan
    if plan is None:
        raise AssertionError("[3j] K2-seg's operator split no row")
    acc0 = x0.flip(0).contiguous()
    got, want = (torch.empty_like(x0), acc0.clone()), (torch.empty_like(x0),
                                                       acc0.clone())
    spmm_segment_prop_step(padded, x0, *got, scale, True)
    torch.cuda.synchronize(DEV)
    spmm_segment_prop_step_plain(padded, x0, *want, scale, True)
    under = torch.ones(n, dtype=torch.bool, device=DEV)
    under[plan.rows.long()] = False
    err = max(_errors(got[0], want[0]), _errors(got[1], want[1]),
              key=lambda e: e[1])
    differ = sum(int((g[under] != w[under]).sum()) for g, w in zip(got, want))
    del got, want, acc0
    y, acc = torch.empty_like(x0), x0.clone()
    ms = _time_ms(lambda: spmm_segment_prop_step(padded, x0, y, acc, scale,
                                                 True), 30)
    plain_ms = _time_ms(lambda: spmm_segment_prop_step_plain(
        padded, x0, y, acc, scale, True), 3, warmup=1)
    nbytes = 12 * op.nnz + 16 * n * nfeat
    bound_ms, bound_by = _bound(nbytes, 2 * op.nnz * nfeat + 2 * n * nfeat)
    print(f"[3j] coo_spmm fused hop, split ({plan.rows.numel()} rows, "
          f"{plan.num_chunks} chunks of at most {plan.cap} edges): against "
          f"its plain version max_abs_err {err[0]} max_rel_err {err[1]} "
          f"(limit {TOL}), elements of rows under the cap differing {differ} "
          f"(limit 0); ms {ms} plain_ms {plain_ms} bound_ms {bound_ms} "
          f"({bound_by}, {nbytes / 1e9:.3f} GB)", flush=True)
    if not (err[1] <= TOL and differ == 0):
        raise AssertionError(f"[3j] coo_spmm disagrees with its plain "
                             f"version: {err[1]}, {differ} differ")
    # the bf16-carry form on the same plan: split rows too bit for bit
    xb = x0.bfloat16()
    bf16_differ, ulps_b, abs_b = _bf16_hops(padded, xb, scale, 1)
    yb, accb = torch.empty_like(xb), xb.clone()
    bf16_ms = _time_ms(lambda: spmm_segment_prop_step(padded, xb, yb, accb,
                                                      scale, True), 30)
    del xb, yb, accb
    print(f"[3j] coo_spmm bf16 carries, split: elements differing "
          f"{bf16_differ} (limit 0, split rows included), largest "
          f"difference {ulps_b} bf16 ulps (max_abs_err {abs_b}); ms "
          f"{bf16_ms}", flush=True)
    if bf16_differ:
        raise AssertionError(f"[3j] coo_spmm's bf16 form disagrees with "
                             f"its plain version: {bf16_differ} differ")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bf16_carry": {"ms": bf16_ms, "elements_differing": bf16_differ,
                           "max_bf16_ulps": ulps_b,
                           "max_abs_err": abs_b},
            "bound_by": bound_by, "max_abs_err": err[0],
            "max_rel_err": err[1], "elements_differing_under_cap": differ,
            "split_rows": int(plan.rows.numel()), "chunks": plan.num_chunks}


def _hub_int8_times(op, whole, x0, q, q_scale, row_val, scale) -> dict:
    """3j's times of quantize and of the split and unsplit K2-q8 and
    K2-q8mxu hops on the skew graph, each beside its bytes bound."""
    n, nnz, nfeat = op.num_rows, op.nnz, x0.shape[1]
    y, acc = torch.empty_like(x0), torch.zeros_like(x0)
    struct = 4 * (n + 1) + 4 * nnz
    # q read, f32 y written, acc read and written, the structure; K2-q8
    # reads the values, K2-q8mxu the row values
    q8_bytes = n * nfeat * 13 + nfeat * 4 + struct
    table = {
        "quantize_columns": (
            {"split": lambda: quantize_columns(x0)},
            lambda: quantize_columns_plain(x0), n * nfeat * 5 + nfeat * 4,
            3 * n * nfeat),
        "csr_spmm_q8": (
            {tag: (lambda o=o: spmm_prop_step_q8(o, q, q_scale, y, acc,
                                                 scale, True))
             for tag, o in (("split", op), ("unsplit", whole))},
            lambda: spmm_prop_step_q8_plain(op, q, q_scale, y, acc, scale,
                                            True),
            q8_bytes + 4 * nnz, 2 * nnz * nfeat + 3 * n * nfeat),
        "csr_spmm_q8mxu": (
            {tag: (lambda o=o: spmm_prop_step_q8mxu(o, q, q_scale, row_val,
                                                    y, acc, scale, True))
             for tag, o in (("split", op), ("unsplit", whole))},
            lambda: spmm_prop_step_q8mxu_plain(op, q, q_scale, row_val, y,
                                               acc, scale, True),
            q8_bytes + 4 * n, nnz * nfeat + 4 * n * nfeat)}
    times = {}
    for name, (kernels, plain, nbytes, ops_) in table.items():
        t = {tag: _time_ms(fn, 30) for tag, fn in kernels.items()}
        plain_ms = _time_ms(plain, 3, warmup=1)
        bound_ms, bound_by = _bound(nbytes, ops_)
        times[name] = {"ms": t["split"], "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": None}
        line = f"ms {t['split']}"
        if "unsplit" in t:
            times[name].update(unsplit_ms=t["unsplit"],
                               **_int8_times(kernels["split"], op, q,
                                             q_scale, y, acc, nbytes))
            line = (f"split ms {t['split']} unsplit ms {t['unsplit']} "
                    f"(split faster by {t['unsplit'] / t['split']:.3f}x); "
                    f"split {_int8_line(times[name])};")
        print(f"[3j] {name} at [{n},{nfeat}], nnz {nnz}: {line} plain_ms "
              f"{plain_ms} bound_ms {bound_ms} ({bound_by}, "
              f"{nbytes / 1e9:.3f} GB)", flush=True)
    return times


def _k3_form_sets(attr_cols, attr_vals, form: str, g):
    """Eight input sets of one K3 form (distinct rows in turn, so timed
    gathers miss the L2 as the main path's fresh batches do)."""
    rows, ktop, num_aug, n_eval, chunk = K3_SHAPE
    n = attr_cols.shape[0]
    sets = []
    for i in range(8):
        if form == "node":
            sl = slice(i * chunk, (i + 1) * chunk)
            sets.append({"attr_cols": attr_cols[sl], "attr_vals": attr_vals[sl]})
            continue
        r, k = (n_eval, 1) if form == "eval" else (rows, num_aug)
        s = {"attr_cols": attr_cols, "attr_vals": attr_vals,
             "tk_cols": torch.randint(0, n, (r, ktop), generator=g,
                                      device=DEV, dtype=torch.int32),
             "tk_vals": torch.rand(r, ktop, generator=g, device=DEV)}
        if form != "eval":    # the preset's DropNode rate, 0.5
            s["keep"] = torch.rand(k, r, ktop, generator=g, device=DEV) < 0.5
        if form == "train_q0.5":
            s["drop"] = torch.rand(k, r, ktop, attr_cols.shape[1], H_MAG,
                                   generator=g, device=DEV) < 0.5
        sets.append(s)
    return sets


def _k3_library(table, s):
    """``F.embedding_bag`` over the same ids with the combined weights
    w/D * a/(S + 1e-10): the same function when nothing is dropped."""
    if "tk_cols" not in s:
        ids, a = s["attr_cols"].long(), s["attr_vals"]
        return ids, a / (a.sum(-1, keepdim=True) + 1e-10)
    idx = s["tk_cols"].long()
    a = s["attr_vals"][idx]                                # [R, Ktop, P]
    vals = s["tk_vals"][None]
    w = vals if "keep" not in s else torch.where(s["keep"], vals, 0.0)
    w = w / (w.sum(-1, keepdim=True) + 1e-12)              # [K, R, Ktop]
    psw = w[..., None] * (a / (a.sum(-1, keepdim=True) + 1e-10))[None]
    ids = s["attr_cols"][idx].long().expand(psw.shape)
    return (ids.reshape(-1, ids.shape[-2] * ids.shape[-1]),
            psw.reshape(ids.shape[0] * ids.shape[1], -1))


def _k3_bytes(table, s, num_aug):
    """Least bytes and ops of one K3 forward and backward on set ``s``:
    each distinct table row and attr row read once, the masks and the
    output once; the backward writes the whole dense [V, H] gradient."""
    h, p = table.shape[1], s["attr_cols"].shape[1]
    if "tk_cols" in s:
        n_nodes = torch.unique(s["tk_cols"]).numel()
        ids = s["attr_cols"][s["tk_cols"].long()]
        live = s["attr_vals"][s["tk_cols"].long()] != 0
        rows, ktop = s["tk_cols"].shape
        topk = rows * ktop * 8
    else:
        ids, live = s["attr_cols"], s["attr_vals"] != 0
        rows, ktop, topk = s["attr_cols"].shape[0], 1, 0
        n_nodes = rows
    uniq = torch.unique(ids[live]).numel()
    masks = sum(s[k].numel() for k in ("keep", "drop") if k in s)
    common = n_nodes * p * 8 + topk + masks
    out = num_aug * rows * h * 4
    nk = num_aug if "drop" in s else 1
    flops = 2 * nk * int(live.sum()) * h + 2 * num_aug * rows * ktop * h
    return (uniq * h * 4 + common + out, flops,
            table.numel() * 4 + common + out, flops)


def _k3_scratch_bytes(s: dict, h: int, lo: int = 0,
                      hi: int | None = None) -> int:
    """The K3 backward's own traffic beyond the least bytes of
    :func:`_k3_bytes` (``csrc/embed_prop.cu``) on set ``s`` over the
    window [lo, hi): the slots' term vectors written and read back once;
    each entry's id and value written and its id read; each live entry's
    value read, and its entry and value written into its id's row and read
    back; each id's listing written and read; and for each id with more
    entries than its row holds (min(32, (H - 1) // 2)) every entry's id
    read once more."""
    if "tk_cols" in s:
        idx = s["tk_cols"].long()
        ids, vals = s["attr_cols"][idx], s["attr_vals"][idx]
        w = (s["tk_vals"][None] if "keep" not in s
             else torch.where(s["keep"], s["tk_vals"][None], 0.0))
        live = (w != 0).any(0)[..., None] & (vals != 0)
        rows, ktop = s["tk_cols"].shape
    else:
        ids, vals = s["attr_cols"], s["attr_vals"]
        live = vals != 0
        rows, ktop = ids.shape[0], 1
    live &= ids >= lo
    if hi is not None:
        live &= ids < hi
    n_live = int(live.sum())
    counts = torch.unique(ids[live], return_counts=True)[1]
    n_long = int((counts > min(32, (h - 1) // 2)).sum())
    nk = s["drop"].shape[0] if "drop" in s else 1
    entries = rows * ktop * s["attr_cols"].shape[1]
    return (2 * rows * ktop * nk * h * 4 + entries * 12 + n_live * 20
            + counts.numel() * 12 + n_long * entries * 4)


def _k3_backward_checked(d_k, gout, lo, hi, s, q, tag):
    """The backward's gradient ``d_k`` against ``embed_prop_backward_plain``
    on the same inputs (it adds in the kernels' order): the errors and
    whether the bits are equal; raises above TOL."""
    d_p = embed_prop_backward_plain(gout, lo, hi, **s, droprate=q)
    err = _errors(d_k, d_p)
    if err[1] > TOL:
        raise AssertionError(f"K3 backward {tag} disagrees with its plain "
                             f"version: {err}")
    return err, bool(torch.equal(d_k, d_p))


def _no_sort(sort_ms, tag):
    """The backward runs no sort kernel."""
    if sort_ms:
        raise AssertionError(f"K3 backward {tag}: a sort ran on the device "
                             f"({sort_ms} ms a call)")
    return sort_ms


def _k3_column_blocks(table, sets, q: float, g) -> dict:
    """K3's forward and backward on each column block [V, H/m] of ``table``
    as phase 9tb's step runs them on a (d x m) = ``TP_SHAPE`` mesh: each
    model shard's block over its data row's rows (the first 1/d of each
    set's), the input-dropout mask's matching columns, against the plain
    version on the same inputs; the device times of both kernels there."""
    n_data, m = TP_SHAPE
    w = table.shape[1] // m

    def shard_set(s, c):
        r = s["tk_cols"].shape[0] // n_data
        out = {**s, "tk_cols": s["tk_cols"][:r], "tk_vals": s["tk_vals"][:r]}
        if "keep" in s:
            out["keep"] = s["keep"][:, :r].contiguous()
        if "drop" in s:
            out["drop"] = s["drop"][:, :r, ..., c * w:(c + 1) * w].contiguous()
        return out

    errs = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}
    first, bits_equal = None, True
    for c in range(m):
        t = table.detach()[:, c * w:(c + 1) * w].contiguous()
        t.requires_grad_(True)
        bsets = [shard_set(s, c) for s in sets]
        out = embed_prop(t, **bsets[0], droprate=q)
        gout = torch.randn(out.shape, generator=g, device=DEV)
        d_k, = torch.autograd.grad(out, t, gout)
        plain = embed_prop_plain(t, **bsets[0], droprate=q)
        d_p, = torch.autograd.grad(plain, t, gout)
        pb_err, pb_bits = _k3_backward_checked(
            d_k, gout, 0, t.shape[0], bsets[0], q, f"on column block {c}")
        bits_equal = bits_equal and pb_bits
        for key, e in (("fwd", _errors(out.detach(), plain.detach())),
                       ("bwd", _errors(d_k, d_p)), ("bwd", pb_err)):
            errs[key] = [max(a, b) for a, b in zip(errs[key], e)]
        del out, plain, d_k, d_p
        if first is None:
            first = (t, bsets)
    if not (errs["fwd"][1] <= TOL and errs["bwd"][1] <= TOL):
        raise AssertionError(f"K3 on a column block of {w} disagrees with "
                             f"its plain version: {errs}")
    t, bsets = first
    it = itertools.cycle(bsets)
    with torch.no_grad():
        dev_f = _device_ms(lambda: embed_prop(t, **next(it), droprate=q), 100,
                           "embed_prop_fwd_kernel")
    outs = [embed_prop(t, **s, droprate=q) for s in bsets]
    it_o = itertools.cycle(outs)
    gout = torch.randn(outs[0].shape, generator=g, device=DEV)
    def grad_next():
        return torch.autograd.grad(next(it_o), t, gout, retain_graph=True)

    dev_b, by_kernel = _call_device_ms(grad_next, 20)
    sort_b = _no_sort(_sort_ms(grad_next, 20), "on a column block")
    b_f, o_f, b_b, o_b = _k3_bytes(t, bsets[0], outs[0].shape[0])
    scratch = _k3_scratch_bytes(bsets[0], w)
    bounds = {"fwd": _bound(b_f, o_f), "bwd": _bound(b_b, o_b)}
    bound_scratch = _bound(b_b + scratch, o_b)[0]
    shape = f"[{outs[0].shape[0]},{outs[0].shape[1]},{w}] of {m} blocks"
    print(f"[K3] {shape}: fwd vs plain {errs['fwd']}, bwd vs plain "
          f"{errs['bwd']}; on the device, profiled: fwd {dev_f} (bound "
          f"{bounds['fwd'][0]}, {b_f / 1e6:.3f} MB), bwd every device "
          f"operation {dev_b} ({by_kernel}; sort {sort_b}; bound "
          f"{bounds['bwd'][0]}, {b_b / 1e6:.1f} MB; with the scratch "
          f"{bound_scratch}, +{scratch / 1e6:.2f} MB); bwd bit for bit its "
          f"plain version: {bits_equal}", flush=True)
    out = {key: {"shape": shape, "device_ms": dev,
                 "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
                 "max_abs_err": errs[key][0], "max_rel_err": errs[key][1]}
           for key, dev in (("fwd", dev_f), ("bwd", dev_b))}
    out["bwd"].update(sort_device_ms=sort_b, by_kernel_ms=by_kernel,
                      bound_with_scratch_ms=bound_scratch,
                      plain_bits_equal=bits_equal)
    return out


def check_k3(padded) -> list:
    """K3 forward and backward against the plain version and autograd, in
    the train (with and without input dropout), eval and node forms, on
    the MAG stand-in's ``padded`` features; the train and eval forms also
    on the table's column blocks, as the split step runs them."""
    g = torch.Generator(device=DEV).manual_seed(1)
    table = torch.randn(padded.num_features, H_MAG, generator=g, device=DEV)
    table.requires_grad_(True)
    attr_cols = torch.as_tensor(padded.attr_cols, device=DEV)
    attr_vals = torch.as_tensor(padded.attr_vals, device=DEV)
    errs = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}
    times = {"fwd": {}, "bwd": {}}
    for form in ("train", "train_q0.5", "eval", "node"):
        q = 0.5 if form == "train_q0.5" else 0.0
        sets = _k3_form_sets(attr_cols, attr_vals, form, g)
        outs = [embed_prop(table, **s, droprate=q) for s in sets]
        num_aug = outs[0].shape[0]
        gout = torch.randn(outs[0].shape, generator=g, device=DEV)
        d_k, = torch.autograd.grad(outs[0], table, gout, retain_graph=True)
        torch.cuda.synchronize(DEV)
        plains = [embed_prop_plain(table, **s, droprate=q) for s in sets]
        d_p, = torch.autograd.grad(plains[0], table, gout, retain_graph=True)
        e_f = _errors(outs[0].detach(), plains[0].detach())
        # the backward adds an id's terms in entry order, autograd in another
        e_b = _errors(d_k, d_p)
        # its plain version adds in the kernels' order
        e_pb, bits_b = _k3_backward_checked(d_k, gout, 0, table.shape[0],
                                            sets[0], q, form)
        e_b = [max(a, b) for a, b in zip(e_b, e_pb)]
        del d_k, d_p
        for key, e in (("fwd", e_f), ("bwd", e_b)):
            errs[key] = [max(a, b) for a, b in zip(errs[key], e)]
        if not (e_f[1] <= TOL and e_b[1] <= TOL):
            raise AssertionError(f"K3 {form} disagrees with its plain "
                                 f"version: fwd {e_f}, bwd {e_b}")
        if form != "node":
            blocks = _k3_column_blocks(table, sets, q, g)
            for key in ("fwd", "bwd"):
                times[key][f"{form}_columns"] = blocks[key]
                errs[key] = [max(errs[key][0], blocks[key]["max_abs_err"]),
                             max(errs[key][1], blocks[key]["max_rel_err"])]

        it = itertools.cycle(sets)
        with torch.no_grad():
            ms_f = _time_ms(lambda: embed_prop(table, **next(it),
                                               droprate=q), 200)
            plain_f = _time_ms(lambda: embed_prop_plain(
                table, **next(it), droprate=q), 20)
            dev_f = _device_ms(lambda: embed_prop(table, **next(it),
                                                  droprate=q), 100,
                               "embed_prop_fwd_kernel")
        it_o, it_p = itertools.cycle(outs), itertools.cycle(plains)

        def grad_next():
            return torch.autograd.grad(next(it_o), table, gout,
                                       retain_graph=True)

        # autograd's wall (host dispatch included) and every device
        # operation of one call (no sort may run)
        ms_b = _time_ms(grad_next, 50)
        dev_b, by_kernel = _call_device_ms(grad_next, 20)
        sort_b = _no_sort(_sort_ms(grad_next, 20), form)
        plain_b = _time_ms(lambda: torch.autograd.grad(
            next(it_p), table, gout, retain_graph=True), 20)
        lib_f = lib_b = lib_dev_b = None
        if q == 0.0:
            libs = [_k3_library(table, s) for s in sets]
            it_l = itertools.cycle(libs)

            def bag(ids_w):
                return F.embedding_bag(ids_w[0], table, mode="sum",
                                       per_sample_weights=ids_w[1])

            with torch.no_grad():
                lib_err = _errors(bag(libs[0]), outs[0].reshape(
                    -1, H_MAG).detach())[1]
                lib_f = _time_ms(lambda: bag(next(it_l)), 200)
            print(f"[K3] {form}: embedding_bag vs the kernel, max rel err "
                  f"{lib_err}", flush=True)
            lib_outs = [bag(iw) for iw in libs]
            lg = torch.randn(lib_outs[0].shape, generator=g, device=DEV)
            it_lo = itertools.cycle(lib_outs)
            def lib_grad():
                return torch.autograd.grad(next(it_lo), table, lg,
                                           retain_graph=True)

            lib_b = _time_ms(lib_grad, 50)
            lib_dev_b = _call_device_ms(lib_grad, 20)[0]
            del lib_outs, libs
        b_f, o_f, b_b, o_b = _k3_bytes(table, sets[0], num_aug)
        (bound_f, by_f), (bound_b, by_b) = _bound(b_f, o_f), _bound(b_b, o_b)
        scratch = _k3_scratch_bytes(sets[0], H_MAG)
        bound_scratch = _bound(b_b + scratch, o_b)[0]
        shape = (f"[{num_aug},{outs[0].shape[1]},{H_MAG}]" if form != "node"
                 else f"[1,{K3_SHAPE[4]},{H_MAG}] node form")
        times["fwd"][form] = {"shape": shape, "ms": ms_f, "device_ms": dev_f,
                              "plain_ms": plain_f,
                              "library_ms": lib_f, "bound_ms": bound_f,
                              "bound_by": by_f, "max_rel_err": e_f[1]}
        times["bwd"][form] = {"shape": shape, "ms": ms_b, "device_ms": dev_b,
                              "by_kernel_ms": by_kernel,
                              "sort_device_ms": sort_b, "plain_ms": plain_b,
                              "library_ms": lib_b,
                              "library_device_ms": lib_dev_b,
                              "bound_ms": bound_b, "bound_by": by_b,
                              "max_rel_err": e_b[1],
                              "plain_bits_equal": bits_b,
                              "bound_with_scratch_ms": bound_scratch}
        print(f"[K3] {form} {shape}: fwd ms {ms_f} (on the device, "
              f"profiled: {dev_f}) plain_ms {plain_f} "
              f"library_ms {lib_f} bound_ms {bound_f} ({by_f}, "
              f"{b_f / 1e6:.2f} MB) err {e_f}; bwd ms through autograd "
              f"{ms_b} (on the device, profiled: every operation {dev_b}, "
              f"{by_kernel}; sort {sort_b}) plain_ms {plain_b} library_ms "
              f"{lib_b} (on the device {lib_dev_b}) bound_ms {bound_b} "
              f"({by_b}, {b_b / 1e6:.1f} MB; with the scratch "
              f"{bound_scratch}, +{scratch / 1e6:.2f} MB) err {e_b}, bit "
              f"for bit its plain version {bits_b}", flush=True)
        del outs, plains, sets

    # the node form over all 1M nodes, as the predict runs it
    with torch.no_grad():
        all_ms = _time_ms(lambda: embed_all_nodes(table, attr_cols,
                                                  attr_vals), 3, warmup=1)
        all_dev = _device_ms(lambda: embed_all_nodes(table, attr_cols,
                                                     attr_vals), 2,
                             "embed_prop_fwd_kernel",
                             -(-attr_cols.shape[0] // K3_SHAPE[4]))
    live = attr_vals != 0
    uniq = torch.unique(attr_cols[live]).numel()
    n, p = attr_cols.shape
    nbytes = uniq * H_MAG * 4 + n * p * 8 + n * H_MAG * 4
    gathers = int(live.sum())
    all_bound, _ = _bound(nbytes, 2 * gathers * H_MAG)
    print(f"[K3] node form over all {n} nodes ({-(-n // K3_SHAPE[4])} "
          f"launches): ms {all_ms} (the K3 kernels on the device, "
          f"profiled: {all_dev}) bound_ms {all_bound} ({nbytes / 1e9:.3f} "
          f"GB, each distinct row once; {uniq} distinct rows); row gathers "
          f"{gathers} = {gathers * H_MAG * 4 / 1e9:.2f} GB at "
          f"{gathers * H_MAG * 4 / 3.35e12 * 1e3:.3f} ms", flush=True)
    times["fwd"]["node_all"] = {"ms": all_ms, "device_ms": all_dev,
                                "bound_ms": all_bound, "row_gathers": gathers}
    entries = []
    for key, line in (("fwd", 80), ("bwd", 87)):
        main = times[key]["train"]
        entries.append({
            "name": f"embed_prop_{key}", "route": "cuda",
            "source": "grandtpu_torch/csrc/embed_prop.cu",
            "replaces": f"grandtpu/nn/sparse_input.py:{line}",
            "max_abs_err": errs[key][0], "max_rel_err": errs[key][1],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["shape"],
            "device_ms": main["device_ms"], "forms": times[key]})
    return entries


def _ppr_hop_by_hop(hop, plain_hop, x0, order: int, quantize: bool):
    """``order`` ppr hops of ``hop`` against ``plain_hop`` on a shared
    input: at each hop both take the plain run's carries (and, for the int8
    hops, its quantized input), so one hop's rounding does not carry into
    the next. The int8 kernel hops also raise their column maxima
    (``amax_out``, a pair of buffers as the Propagator's), each held bit for
    bit to ``column_absmax`` of the y the hop stored, and the quantize of
    each hop but the first runs in its one-launch form on that y and those
    maxima (zeroing the other buffer), held bit for bit to the plain
    quantize of that y. Returns the max (abs, rel) error over the hops'
    outputs and accumulators, the count of their elements that differ, and
    the count of q, scale and maxima elements that differ."""
    cur_in, acc = x0, x0.clone()
    worst, differ, q_diff = (0.0, 0.0), 0, 0
    pair = torch.zeros((2, x0.shape[1]), device=x0.device)
    prev_y = None
    for t in range(order):
        args, extra = (cur_in,), ()
        if quantize:
            if prev_y is None:
                y_in = cur_in
                q, scale = quantize_columns(y_in)
            else:
                y_in = prev_y
                q, scale = quantize_with_amax(y_in, pair[(t - 1) % 2],
                                              pair[t % 2])
            q_p, scale_p = quantize_columns_plain(y_in)
            torch.cuda.synchronize(DEV)
            q_diff += int((q != q_p).sum()) + int((scale != scale_p).sum())
            q_diff += int(pair[t % 2].count_nonzero())   # zeroed
            args, extra = quantize_columns_plain(cur_in), (pair[t % 2],)
            del q, q_p
        out_k, acc_k = torch.empty_like(cur_in), acc.clone()
        out_p, acc_p = torch.empty_like(cur_in), acc.clone()
        hop(*args, out_k, acc_k, *extra)
        torch.cuda.synchronize(DEV)
        plain_hop(*args, out_p, acc_p)
        for got, want in ((out_k, out_p), (acc_k, acc_p)):
            e = _errors(got.float(), want.float())
            worst = (max(worst[0], e[0]), max(worst[1], e[1]))
            differ += int((got != want).sum())
        if quantize:
            q_diff += int((pair[t % 2] != column_absmax(out_k)).sum())
            prev_y = out_k
        del acc_k
        cur_in, acc = out_p, acc_p
    return worst, differ, q_diff


def _plain_ppr_run(plain_hop, x0, order: int, quantize: bool):
    """``order`` ppr hops of the plain versions alone (the Propagator's loop
    with ``plain_hop``); returns the accumulator. ``x0`` is not written."""
    cur_in, acc = x0.clone(), x0.clone()
    cur_out = torch.empty_like(x0)
    for _ in range(order):
        args = quantize_columns_plain(cur_in) if quantize else (cur_in,)
        plain_hop(*args, cur_out, acc)
        cur_in, cur_out = cur_out, cur_in
    return acc


def amazon_operators(data) -> dict:
    """The Amazon2M stand-in's operator as f32- and bf16-carry Propagators
    on the card, with its features there."""
    adj_sl = add_self_loops_adj(data.adj)
    return {"adj": adj_sl,
            "f32": Propagator(adj_sl, backend="csr", device=DEV),
            "bf16": Propagator(adj_sl, backend="csr", dtype=torch.bfloat16,
                               device=DEV),
            "x": torch.as_tensor(data.features, device=DEV)}


def check_fast_kernels(ops: dict, k2: dict) -> list:
    """Phase 3d: each fast-precision kernel hop by hop against its plain
    version at the Amazon2M shape, each whole run against f32 K2, and
    their times and bounds; adds K2 (f32) at this shape to ``k2``."""
    cfg = preset("Amazon2M")
    prop, x = ops["f32"], ops["x"]
    op, row_val = prop.adj_op, prop.row_val
    n, nnz, nfeat = op.num_rows, op.nnz, x.shape[1]
    scale, order = 1.0 - cfg.alpha, cfg.order
    x0 = cfg.alpha * x
    bf = torch.bfloat16
    x0_b = x.to(bf) * float(torch.tensor(cfg.alpha).to(bf))

    def k2_hop(term):
        fn = spmm_prop_step if term == "f32" else spmm_prop_step_bf16
        return (lambda ci, co, ac: fn(op, ci, co, ac, scale, True),
                lambda ci, co, ac: spmm_prop_step_plain(op, ci, co, ac,
                                                        scale, True, term))

    # form: (kernel hop, plain hop, first input, quantized, per-hop limit),
    # in the order of the whole runs below. The plain hops add in the
    # kernels' order, so with bf16 carries the hop must be bit for bit the
    # plain one: a rounding done another way (an unrounded scale, say)
    # moves a large share of the elements by one bf16 ulp
    forms = {
        "bf16": (*k2_hop("bf16"), x0, False, TOL),
        "bf16_carry": (*k2_hop("bf16"), x0_b, False, 0.0),
        "q8": (lambda q, s, co, ac, am=None: spmm_prop_step_q8(
                   op, q, s, co, ac, scale, True, am),
               lambda q, s, co, ac: spmm_prop_step_q8_plain(
                   op, q, s, co, ac, scale, True), x0, True, TOL),
        "q8mxu": (lambda q, s, co, ac, am=None: spmm_prop_step_q8mxu(
                      op, q, s, row_val, co, ac, scale, True, am),
                  lambda q, s, co, ac: spmm_prop_step_q8mxu_plain(
                      op, q, s, row_val, co, ac, scale, True), x0, True,
                  1e-6),
    }
    # the int8 hops with bf16 carries, bit for bit (after the four forms
    # that the whole runs below pair with)
    for form in ("q8", "q8mxu"):
        forms[f"{form}_carry"] = (*forms[form][:2], x0_b, True, 0.0)
    errs, q_diff = {}, 0
    for form, (hop, plain_hop, start, quantize, limit) in forms.items():
        errs[form], differ, qd = _ppr_hop_by_hop(hop, plain_hop, start,
                                                 order, quantize)
        q_diff += qd
        print(f"[3d] {form}: {order} ppr hops at [{n},{nfeat}], nnz {nnz}, "
              f"one at a time on a shared input: max_abs_err "
              f"{errs[form][0]} max_rel_err {errs[form][1]} (limit {limit}), "
              f"elements differing {differ}"
              + (f", quantize q/scale/maxima elements differing {qd} "
                 "(the later hops' quantize on the maxima the hop before "
                 "raised)" if quantize else ""), flush=True)
        if not errs[form][1] <= limit:
            raise AssertionError(f"{form} disagrees with its plain version: "
                                 f"{errs[form][1]} > {limit}")
    if q_diff:
        raise AssertionError(f"the quantize or the hops' maxima differ from "
                             f"their plain versions in {q_diff} elements")

    # whole runs of `order` hops: each kernel run against the plain run of
    # the same precision (flips carry from hop to hop, so the fast-path
    # limits), and no further from f32 than the plain arithmetic is
    kw = dict(mode="ppr", order=order, alpha=cfg.alpha)
    ref = prop(x, **kw)
    ref_plain = _plain_ppr_run(k2_hop("f32")[1], x0, order, False)
    # K2 (f32) at this width takes its 4-features-a-lane path
    f32_err = _errors(ref, ref_plain)
    print(f"[3d] csr_spmm_prop: {order} ppr hops at [{n},{nfeat}] against "
          f"its plain version: max_abs_err {f32_err[0]} max_rel_err "
          f"{f32_err[1]} (limit {TOL})", flush=True)
    if not f32_err[1] <= TOL:
        raise AssertionError(f"K2 disagrees with its plain version at "
                             f"[{n},{nfeat}]: {f32_err[1]} > {TOL}")
    runs = {"bf16": prop(x, precision="bf16", **kw),
            "bf16_carry": ops["bf16"](x, precision="bf16", **kw),
            "int8cast": prop(x, precision="int8cast", **kw),
            "int8": prop(x, precision="int8", **kw)}
    whole = {}
    for (p, out), form in zip(runs.items(), forms):
        plain = _plain_ppr_run(forms[form][1], forms[form][2], order,
                               forms[form][3])
        d = _errors(out.float(), plain.float())[1]
        e_k = _errors(out.float(), ref)[1]
        e_p = _errors(plain.float(), ref_plain)[1]
        limit = 2e-2 if p == "bf16_carry" else 5e-3
        whole[p] = {"vs_plain": d, "vs_f32": e_k, "plain_vs_f32": e_p}
        print(f"[3d] whole {order}-hop run {p}: vs its plain run max_rel_err "
              f"{d} (limit {limit}); vs f32 K2 {e_k}, plain vs plain f32 "
              f"{e_p} (fast-path gate {limit}: "
              f"{'held' if e_k <= limit else 'exceeded'})", flush=True)
        if not (d <= limit and e_k <= e_p + 1e-3):
            raise AssertionError(f"{p} run: {d} from its plain run (limit "
                                 f"{limit}), {e_k} from f32 against the "
                                 f"plain run's {e_p}")
        del plain
    del runs, ref, ref_plain

    # times and bounds, one hop (quantize: one call) at the main path's shape
    y, acc = torch.empty_like(x), torch.zeros_like(x)
    y_b, acc_b = torch.empty_like(x0_b), torch.zeros_like(x0_b)
    q, q_scale = quantize_columns(x0)
    amax = column_absmax(x0)
    # the maxima a hop raises, and the buffer the next quantize zeroes
    pair = torch.zeros((2, nfeat), device=DEV)
    struct = 4 * (n + 1) + 4 * nnz
    k2_bytes = 4 * n * nfeat * 4 + 8 * nnz + 4 * (n + 1)
    carry_bytes = 4 * n * nfeat * 2 + 8 * nnz + 4 * (n + 1)
    # q read, f32 y written, acc read and written, the structure
    q8_bytes = n * nfeat * 13 + nfeat * 4 + struct

    def bf16_library():
        """torch.sparse.mm of a bf16 CSR tensor by bf16 x (A x only), if
        this build has it."""
        try:
            a_b = torch.sparse_csr_tensor(op.indptr, op.indices,
                                          op.values.to(bf), size=(n, n))
            torch.sparse.mm(a_b, x0_b)
            torch.cuda.synchronize(DEV)
        except RuntimeError as e:
            print(f"[3d] torch.sparse.mm on bf16 CSR: not in this build "
                  f"({str(e).splitlines()[0][:120]})", flush=True)
            return None
        return _time_ms(lambda: torch.sparse.mm(a_b, x0_b), 30)

    table = {
        "csr_spmm_prop_bf16": (
            lambda: spmm_prop_step_bf16(op, x0, y, acc, scale, True),
            lambda: spmm_prop_step_plain(op, x0, y, acc, scale, True,
                                         "bf16"),
            None, k2_bytes, 2 * nnz * nfeat + 2 * n * nfeat),
        "csr_spmm_prop_bf16_carry": (
            lambda: spmm_prop_step_bf16(op, x0_b, y_b, acc_b, scale, True),
            lambda: spmm_prop_step_plain(op, x0_b, y_b, acc_b, scale, True,
                                         "bf16"),
            bf16_library, carry_bytes, 2 * nnz * nfeat + 2 * n * nfeat),
        "quantize_columns": (
            lambda: quantize_columns(x0), lambda: quantize_columns_plain(x0),
            None, n * nfeat * 5 + nfeat * 4, 3 * n * nfeat),
        # the later hops' quantize: one launch on the maxima the hop before
        # raised (amax read, x read, q and the scales written, the next
        # buffer zeroed)
        "quantize_with_amax": (
            lambda: quantize_with_amax(x0, amax, pair[1]),
            lambda: quantize_with_amax_plain(x0, amax, pair[1]),
            None, n * nfeat * 5 + nfeat * 12, 3 * n * nfeat),
        "csr_spmm_q8": (
            lambda: spmm_prop_step_q8(op, q, q_scale, y, acc, scale, True),
            lambda: spmm_prop_step_q8_plain(op, q, q_scale, y, acc, scale,
                                            True),
            None, q8_bytes + 4 * nnz, 2 * nnz * nfeat + 3 * n * nfeat),
        "csr_spmm_q8mxu": (
            lambda: spmm_prop_step_q8mxu(op, q, q_scale, row_val, y, acc,
                                         scale, True),
            lambda: spmm_prop_step_q8mxu_plain(op, q, q_scale, row_val, y,
                                               acc, scale, True),
            None, q8_bytes + 4 * n, nnz * nfeat + 4 * n * nfeat),
    }
    times = {}
    for name, (kernel, plain, library, nbytes, ops_) in table.items():
        ms = _time_ms(kernel, 30)
        plain_ms = _time_ms(plain, 3, warmup=1)
        library_ms = library() if library is not None else None
        bound_ms, bound_by = _bound(nbytes, ops_)
        times[name] = {"ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by}
        gathers = ""
        if name.startswith("csr_spmm_prop"):
            times[name].update(_gathers(op, x0_b if "carry" in name else x0))
            gathers = (f"; gathered {times[name]['gather_bytes'] / 1e9:.3f} "
                       f"GB = {times[name]['gather_ms']} ms at the HBM rate")
        if name in ("csr_spmm_q8", "csr_spmm_q8mxu"):
            times[name].update(_int8_times(kernel, op, q, q_scale, y, acc,
                                           nbytes))
            gathers = "; " + _int8_line(times[name])
            # the same hop raising its column maxima (the amax words only
            # grow, so later launches mostly skip the atomics, as a hop of
            # a run does after its first blocks)
            args = (q, q_scale) + ((row_val,) if name == "csr_spmm_q8mxu"
                                   else ())
            fn = (spmm_prop_step_q8 if name == "csr_spmm_q8"
                  else spmm_prop_step_q8mxu)
            am_ms = _time_ms(lambda: fn(op, *args, y, acc, scale, True,
                                        pair[0]), 30)
            times[name]["amax_ms"] = am_ms
            gathers += (f"; with amax_out ms {am_ms} "
                        f"({am_ms / ms - 1:+.2%} against without)")
        print(f"[3d] {name} at [{n},{nfeat}], nnz {nnz}: ms {ms} plain_ms "
              f"{plain_ms} library_ms {library_ms} bound_ms {bound_ms} "
              f"({bound_by}, {nbytes / 1e9:.3f} GB){gathers}", flush=True)
    _int8_streams(op, q, acc, y)
    del y, acc, y_b, acc_b, q
    # the whole int8 runs: one full quantize, then each later hop's
    # quantize on the maxima the hop before raised
    for p, name in (("int8", "csr_spmm_q8mxu"), ("int8cast", "csr_spmm_q8")):
        run_ms = _time_ms(lambda: prop(x, precision=p, **kw), 10)
        whole[p]["ms"] = run_ms
        times[name]["run_ms"] = run_ms
        print(f"[3d] whole {order}-hop {p} run ({name}): ms {run_ms} "
              f"(with a full quantize every hop, on an H100 80GB HBM3 at "
              f"700 W: 13.942 int8, 14.063 int8cast)", flush=True)
    t = _k2_times(op, x0, scale)
    print(f"[3d] csr_spmm_prop at [{n},{nfeat}], nnz {nnz}: {_k2_line(t)}",
          flush=True)
    k2["max_abs_err"] = max(k2["max_abs_err"], f32_err[0])
    k2["max_rel_err"] = max(k2["max_rel_err"], f32_err[1])
    k2["amazon"] = {"shape": f"x [{n},{nfeat}], nnz {nnz}, per hop",
                    **{k: v for k, v in t.items() if k != "bytes"},
                    "max_abs_err": f32_err[0], "max_rel_err": f32_err[1]}
    carry = times.pop("csr_spmm_prop_bf16_carry")
    shape = f"x [{n},{nfeat}], nnz {nnz}, per hop"
    sources = {"csr_spmm_prop_bf16": ("csr_spmm.cu", "grandtpu/sparse/"
                                      "spmm.py:197", errs["bf16"]),
               "quantize_columns": ("csr_spmm_q8.cu",
                                    "grandtpu/sparse/spmm.py:452",
                                    (0.0, 0.0)),
               "quantize_with_amax": ("csr_spmm_q8.cu",
                                      "grandtpu/sparse/spmm.py:452",
                                      (0.0, 0.0)),
               "csr_spmm_q8": ("csr_spmm_q8.cu",
                               "grandtpu/sparse/spmm.py:507", errs["q8"]),
               "csr_spmm_q8mxu": ("csr_spmm_q8.cu",
                                  "grandtpu/sparse/spmm.py:607",
                                  errs["q8mxu"])}
    entries = []
    for name, (src, line, err) in sources.items():
        entry = {"name": name, "route": "cuda",
                 "source": f"grandtpu_torch/csrc/{src}", "replaces": line,
                 "max_abs_err": err[0], "max_rel_err": err[1],
                 **times[name],
                 "shape": {"quantize_columns": f"x [{n},{nfeat}] f32, one "
                           "call (two launches: the first hop's)",
                           "quantize_with_amax": f"x [{n},{nfeat}] f32, "
                           "one launch (the later hops')"}.get(name, shape),
                 "whole_run": whole.get(
                     {"csr_spmm_prop_bf16": "bf16", "csr_spmm_q8": "int8cast",
                      "csr_spmm_q8mxu": "int8"}.get(name, ""))}
        if name in ("csr_spmm_q8", "csr_spmm_q8mxu"):
            form = name.removeprefix("csr_spmm_") + "_carry"
            entry["bf16_carry"] = {"max_abs_err": errs[form][0],
                                   "max_rel_err": errs[form][1]}
        if name == "csr_spmm_prop_bf16":
            entry["bf16_carry"] = {**carry, "max_abs_err":
                                   errs["bf16_carry"][0], "max_rel_err":
                                   errs["bf16_carry"][1],
                                   "whole_run": whole["bf16_carry"]}
        entries.append(entry)
    return entries


def check_small_fast() -> None:
    """Phase 4c, first half: ``exact_propagate`` at every precision on the
    card against the CPU, on a graph above the dense threshold."""
    cfg = preset("Amazon2M")
    data = load_data(AMAZON_SMALL, split_seed=cfg.seed1)
    adj_sl = add_self_loops_adj(data.adj)
    for p in ("f32", "bf16", "int8", "int8mxu", "int8cast", "auto",
              "bf16_carry"):
        kw = dict(mode="ppr", order=cfg.order, alpha=cfg.alpha,
                  backend="csr", precision=p)
        gpu = exact_propagate(adj_sl, data.features, device=DEV, **kw)
        cpu = exact_propagate(adj_sl, data.features, device="cpu", **kw)
        err = _errors(gpu.float().cpu(), cpu.float())[1]
        limit = {"f32": 1e-5, "bf16_carry": 2e-2}.get(p, 5e-3)
        print(f"[small-fast] {AMAZON_SMALL} {p}: card vs CPU max_rel_err "
              f"{err} (limit {limit})", flush=True)
        if not (gpu.dtype == cpu.dtype and err <= limit):
            raise AssertionError(f"{p}: card disagrees with the CPU")


def run_amazon_path(data, push_backend: str, tag: str,
                    ckpt_dir: str | None = None):
    """The Amazon2M ``train()`` (phase 5c with the native push, 5d with the
    bucket push and ``ckpt_dir``); returns (result, launches)."""
    cfg = preset("Amazon2M").replace(dataset=AMAZON, epochs=2,
                                     predict_precision="auto",
                                     push_backend=push_backend,
                                     ckpt_dir=ckpt_dir)
    r, launches = run_path(cfg, data, tag)
    if launches["dropnode_mean"] < r.num_batches + len(r.history):
        raise AssertionError("K1 was not launched for every step and eval")
    if r.predict_precision != "int8mxu":
        raise AssertionError(f"auto ran {r.predict_precision}, not int8 as "
                             "K2-q8mxu")
    return r, launches


def precision_sweep(ops: dict) -> dict:
    """Phase 7: ``order`` hops at every precision on one Propagator, with
    error against f32 and peak memory, then ``calibrate()``; every hop
    kernel must launch. Returns the launches."""
    cfg = preset("Amazon2M")
    kw = dict(mode="ppr", order=cfg.order, alpha=cfg.alpha)
    prop, x = ops["f32"], ops["x"]
    _reset_counts()
    ref = prop(x, **kw)
    ref_max = float(ref.abs().max())
    runs = [("f32", prop, "f32"), ("bf16", prop, "bf16"),
            ("int8", prop, "int8"), ("int8cast", prop, "int8cast"),
            ("bf16_carry", ops["bf16"], "bf16")]
    sweep = {}
    for name, pr, p in runs:
        torch.cuda.synchronize(DEV)
        base = torch.cuda.memory_allocated(DEV)
        torch.cuda.reset_peak_memory_stats(DEV)
        out = pr(x, precision=p, **kw)
        torch.cuda.synchronize(DEV)
        peak = (torch.cuda.max_memory_allocated(DEV) - base) / 1e9
        err = float((out.float() - ref).abs().max()) / ref_max
        del out
        ms = _time_ms(lambda: pr(x, precision=p, **kw), 5, warmup=1)
        sweep[name] = {"ms": ms, "rel_err_vs_f32": err,
                       "peak_extra_GB": peak}
        print(f"[sweep] {name}: {cfg.order} hops {ms} ms, max_rel_err vs "
              f"f32 {err}, peak memory above the resident operands {peak} "
              f"GB", flush=True)
    del ref
    t0 = time.time()
    choice = prop.calibrate(x, order=cfg.order, alpha=cfg.alpha)
    launches = _read_counts()
    print(f"[sweep] calibrate() (candidates bf16, int8) chose {choice} in "
          f"{time.time() - t0:.3f} s; launches {launches}", flush=True)
    missing = [k for k in HOP_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"the sweep launched no {missing}")
    return launches


def check_small_reference(cfg) -> None:
    """``train()`` with ``cfg`` (every drop rate 0) on the card and on the
    CPU gives the same validation history and test accuracy."""
    data = load_data(cfg.dataset, split_seed=cfg.seed1)
    gpu = train(cfg, data=data, device=DEV)
    cpu = train(cfg, data=data, device="cpu")
    d_loss = max(abs(a["val_loss"] - b["val_loss"])
                 for a, b in zip(gpu.history, cpu.history, strict=True))
    d_acc = abs(gpu.test_acc - cpu.test_acc) * len(data.idx_test)
    print(f"[small] {cfg.dataset}: {len(gpu.history)} evals, max |d "
          f"val_loss| {d_loss}, test_acc gpu {gpu.test_acc} cpu "
          f"{cpu.test_acc}", flush=True)
    if not (d_loss <= 1e-4 and d_acc <= 1.0 + 1e-9):
        raise AssertionError("GPU run disagrees with the CPU reference")


def train_sources(cfg, data) -> np.ndarray:
    """The source set ``train()`` pushes from (trainer.py's unlabeled
    pool: train, val, then ``unlabel_num`` test nodes drawn with seed2)."""
    rng = np.random.RandomState(cfg.seed2)
    idx_sample = rng.permutation(data.idx_test)[: cfg.unlabel_num]
    return np.concatenate([data.idx_train, data.idx_val, idx_sample])


def _row_rule(cols_a, vals_a, cols_b, vals_b, atol: float) -> None:
    """tests/test_gfpush_backends.py's row rule with tie_tol = atol: equal
    value multisets up to atol, equal (col -> val) maps above the smaller
    row's cutoff by more than atol (ties at the k-th value may differ)."""
    for ca, va, cb, vb in zip(cols_a, vals_a, cols_b, vals_b):
        pa, pb = va > 0, vb > 0
        sa, sb = np.sort(va[pa])[::-1], np.sort(vb[pb])[::-1]
        if sa.shape != sb.shape or not np.allclose(sa, sb, rtol=0,
                                                   atol=atol):
            raise AssertionError(f"row values differ: {sa} vs {sb}")
        cutoff = min(sa[-1] if sa.size else 0.0, sb[-1] if sb.size else 0.0)
        mb = dict(zip(cb[pb].tolist(), vb[pb].tolist()))
        for c, v in zip(ca[pa].tolist(), va[pa].tolist()):
            if v > cutoff + atol and (c not in mb or abs(v - mb[c]) > atol):
                raise AssertionError(f"col {c} ({v}) missing or off")


PUSH_KERNELS = {"jax": {"dense_push_mask", "push_topk", "csr_spmm_prop"},
                "bucket": {"bucket_hop", "bucket_reserve", "push_topk"}}
PUSH_COUNTED = ("dense_push_mask", "bucket_hop", "bucket_reserve",
                "push_topk")


def run_push_path(adj_sl, sources, cfg, backend: str, tag: str):
    """``gfpush(backend=...)`` on the card as a path of its own: counts set
    to 0 just before, read just after; the backend's kernels must launch
    and the other push kernels must not. Returns (TopKProp, launches,
    seconds)."""
    _reset_counts()
    t0 = time.time()
    tk = gfpush(adj_sl, sources, prop_mode=cfg.prop_mode, order=cfg.order,
                alpha=cfg.alpha, rmax=cfg.rmax, k=cfg.top_k, backend=backend,
                device=DEV)
    seconds = time.time() - t0
    launches = _read_counts()
    want = set(PUSH_KERNELS[backend])
    if adj_sl.shape[0] <= 8192:     # gfpush_dense's dense_threshold: matmul
        want.discard("csr_spmm_prop")
    bad = [k for k in PUSH_COUNTED + ("csr_spmm_prop",)
           if (launches[k] > 0) != (k in want)]
    if bad:
        raise AssertionError(f"[{tag}] {backend} push launches {launches}: "
                             f"wrong for {bad}")
    print(f"[{tag}] gfpush(backend={backend!r}) on the card: "
          f"{len(sources)} sources in {seconds} s = {len(sources) / seconds} "
          f"sources/s; launches {launches}", flush=True)
    return tk, launches, seconds


def _p1_times(g, src, coef, k) -> dict:
    """P1's push mask, its K2 over A^T and its top-k at one block's shape,
    on the reserve a real block leaves."""
    n, b = g.n, src.shape[0]
    residue = torch.zeros((n, b), device=DEV)
    residue[src.long(), torch.arange(b, device=DEV)] = 1.0
    reserve, pushed = torch.zeros_like(residue), torch.empty_like(residue)
    tele, tele_in = None, None
    for i in range(coef.shape[0] - 1):       # the block's real carries
        tele = torch.zeros(b, dtype=torch.int64, device=DEV)
        dense_push_mask(residue, reserve, pushed, tele_in, tele, src, g.deg,
                        g.thr, float(coef[i]), False)
        g.product(pushed, residue)
        tele_in = tele
    args = (residue, reserve, pushed, None, tele, src, g.deg, g.thr,
            float(coef[1]), False)
    mask_ms = _time_ms(lambda: dense_push_mask(*args), 20)
    mask_plain = _time_ms(lambda: dense_push_mask_plain(*args), 3, warmup=1)
    mask_bound = _bound(16 * n * b + 8 * n + 12 * b, 5 * n * b)
    k2_ms = _time_ms(lambda: g.product(pushed, residue), 20)
    # K2 over A^T with no update: pushed read once, residue written once,
    # A^T's structure read once; torch.sparse.mm on the same CSR
    op = g.op_t
    k2_bytes = 2 * n * b * 4 + 8 * op.nnz + 4 * (n + 1)
    k2_bound = _bound(k2_bytes, 2 * op.nnz * b)
    a_csr = torch.sparse_csr_tensor(op.indptr, op.indices, op.values,
                                    size=(n, n))
    k2_lib = _time_ms(lambda: torch.sparse.mm(a_csr, pushed), 20)
    del a_csr
    k2_at = {"ms": k2_ms, "library_ms": k2_lib, "bound_ms": k2_bound[0],
             "bound_by": k2_bound[1], "bytes": k2_bytes,
             **_gathers(op, pushed),
             "shape": f"A^T (nnz {op.nnz}), x [{n},{b}], per hop"}
    rows = reserve.t().contiguous().reshape(-1)
    off = torch.arange(b + 1, device=DEV, dtype=torch.int64) * n
    dense_rows = rows.view(b, n)
    # the P1 form, and 4 of its rows made all positive (233,000 keys a row,
    # past the kernel's shared buffer; ties at 1e-6 ordered by id)
    over = (dense_rows[:4].abs() + 1e-6).reshape(-1)
    exact = {}
    for form, (v, o) in {"p1": (rows, off), "overflow": (
            over, torch.arange(5, device=DEV, dtype=torch.int64) * n)}.items():
        got, want = push_topk(None, v, o, k), push_topk_plain(None, v, o, k)
        exact[form] = bool(torch.equal(got[0], want[0])
                           and torch.equal(got[1], want[1]))
    del over
    print(f"[3e] push_topk bit for bit its plain version: {exact}",
          flush=True)
    if not all(exact.values()):
        raise AssertionError(f"push_topk differs from its plain version: "
                             f"{exact}")
    topk_ms = _time_ms(lambda: push_topk(None, rows, off, k), 20)
    topk_plain = _time_ms(lambda: push_topk_plain(None, rows, off, k), 3,
                          warmup=1)
    topk_lib = _time_ms(lambda: torch.topk(dense_rows, k, dim=1), 20)
    topk_bound = _bound(4 * n * b + 8 * b * k + 8 * (b + 1), 2 * n * b)
    print(f"[3e] push_topk P1 form below torch.topk: "
          f"{'held' if topk_ms < topk_lib else 'missed'}", flush=True)
    print(f"[3e] P1 block [{n},{b}]: dense_push_mask ms {mask_ms} plain_ms "
          f"{mask_plain} bound_ms {mask_bound[0]} ({mask_bound[1]}); K2 over "
          f"A^T per hop: ms {k2_ms} library_ms {k2_lib} (torch.sparse.mm) "
          f"bound_ms {k2_bound[0]} ({k2_bound[1]}, {k2_bytes / 1e9:.3f} GB),"
          f" gathered {k2_at['gather_bytes'] / 1e9:.3f} GB = "
          f"{k2_at['gather_ms']} ms at the HBM rate; push_topk over "
          f"[{b},{n}] ms {topk_ms} "
          f"plain_ms {topk_plain} library_ms {topk_lib} (torch.topk) "
          f"bound_ms {topk_bound[0]} ({topk_bound[1]})", flush=True)
    return {"dense_push_mask": {"ms": mask_ms, "plain_ms": mask_plain,
                                "bound_ms": mask_bound[0],
                                "bound_by": mask_bound[1],
                                "library_ms": None,
                                "shape": f"carries [{n},{b}], per hop"},
            "push_topk": {"ms": topk_ms, "plain_ms": topk_plain,
                          "bound_ms": topk_bound[0],
                          "bound_by": topk_bound[1], "library_ms": topk_lib,
                          "shape": f"P1 rows [{b},{n}], k {k}"},
            "k2_over_at": k2_at}


def _check_hop(g, fr, src, got, tag: str, hop: int) -> None:
    """``bucket_hop``'s next frontier bit for bit the plain hop's from the
    same frontier: cnt and exp, and each source's entries ordered by id."""
    want = bucket_push.push_hop_plain(g, fr, src)
    ids, q = bucket_push.by_row_and_id(got.off, got.cnt, got.ids, got.q)
    if not (torch.equal(got.cnt, want.cnt) and torch.equal(got.exp, want.exp)
            and torch.equal(ids, want.ids) and torch.equal(q, want.q)):
        raise AssertionError(f"[{tag}] bucket_hop differs from its plain "
                             f"version at hop {hop}")


def _check_reserve(g, logs, layout, tag: str):
    """``bucket_reserve`` over the block's log bit for bit the plain
    reserve table (each source's ids ordered, their u64 sums and f32
    values); returns the kernel's (ids, f32 values)."""
    ids, sums, vals, cnt = bucket_push.bucket_reserve(logs, layout,
                                                      sums=True)
    row_off, want_ids, want_sums = bucket_push.reserve_table_plain(g, logs)
    got = bucket_push.by_row_and_id(layout.out_off[:-1], cnt, ids, sums,
                                    vals)
    if not (torch.equal(cnt, row_off[1:] - row_off[:-1])
            and torch.equal(got[0], want_ids)
            and torch.equal(got[1], want_sums)
            and torch.equal(got[2], (want_sums.double()
                                     / bucket_push.ONE).float())):
        raise AssertionError(f"[{tag}] bucket_reserve differs from its "
                             f"plain version")
    return ids, vals


def _global_table_slots(n: torch.Tensor) -> int:
    """The table slots the P2 kernels fill in global memory for sources of
    ``n`` inserts: a power of two >= 2 n for each source over 3/4 of the
    shared table (``bucket_push.table_layout``). Traffic of the design,
    24 B a slot (filled, read back), which no bound counts."""
    n = n[4 * n > 3 * bucket_push.SMEM_SLOTS].double()
    return int(torch.exp2(torch.ceil(torch.log2(2 * n))).sum())


def _p2_times(g, src, coef, k, tag: str, spill: bool = False) -> dict:
    """P2's kernels on one block: every hop of ``bucket_hop`` held bit for
    bit to the plain hop from the same frontier, ``bucket_reserve`` over
    the block's log bit for bit to the plain reserve table, and push_topk
    to its plain version; their times at the largest hop and over the
    log, with the plain versions' and the bounds (bytes from this block's
    counts), and each hop's global-table share. With ``spill`` the
    largest hop must put sources on the global table, else some on the
    shared one."""
    b = src.shape[0]
    fr = bucket_push.initial_frontier(g, src)
    logs, hops = [], []
    for i in range(coef.shape[0] - 1):
        logs.append((fr, float(coef[i])))
        layout = bucket_push.table_layout(fr.exp)
        if layout.slots == 0:
            fr = None
            break
        nxt = bucket_push.bucket_hop(g, fr, src, layout)
        _check_hop(g, fr, src, nxt, tag, i)
        hops.append((fr, layout, nxt))
        fr = nxt
    if fr is not None:
        logs.append((fr, float(coef[-1])))
    shares = [lay.global_sources / b for _, lay, _ in hops]
    fr, layout, nxt = max(hops, key=lambda h: h[1].slots)
    if spill and layout.global_sources == 0:
        raise AssertionError(f"[{tag}] no source took the global table at "
                             f"the largest hop")
    if not spill and layout.global_sources == b:
        raise AssertionError(f"[{tag}] no source took the shared table at "
                             f"the largest hop")

    def hop():
        bucket_push.bucket_hop(g, fr, src, layout)

    # the kernel's device time; the wrapper's call adds its error-word read
    hop_ms = _device_ms(hop, 10, "bucket_hop_kernel")
    hop_call = _time_ms(hop, 10)
    hop_plain = _time_ms(lambda: bucket_push.push_hop_plain(g, fr, src), 2,
                         warmup=1)
    entries, slots, out = int(fr.cnt.sum()), layout.slots, int(nxt.cnt.sum())
    table = _global_table_slots(fr.exp)
    # the function's bytes: the frontier (12 B) and one record (16 B) an
    # entry, the neighbour ids (4 B a slot), the next frontier (12 B) and
    # one record an out entry
    hop_bound = _bound(28 * entries + 4 * slots + 28 * out, 2 * slots)
    # the records read as whole 32-byte sectors (they are random)
    hop_sectors_ms = (44 * entries + 4 * slots + 44 * out) \
        / HBM_BYTES_PER_S * 1e3
    table_ms = 24 * table / HBM_BYTES_PER_S * 1e3
    r_layout = bucket_push.reserve_layout(logs)
    r_ids, f32 = _check_reserve(g, logs, r_layout, tag)

    def reserve():
        bucket_push.bucket_reserve(logs, r_layout)

    res_ms = _device_ms(reserve, 10, "bucket_reserve_kernel")
    res_call = _time_ms(reserve, 10)
    res_plain = _time_ms(lambda: bucket_push.reserve_table_plain(g, logs),
                         2, warmup=1)
    n_log = r_layout.slots
    r_table = _global_table_slots(r_layout.out_off[1:]
                                  - r_layout.out_off[:-1])
    r_table_ms = 24 * r_table / HBM_BYTES_PER_S * 1e3
    # the function's bytes: the log read (12 B an entry), ids and f32
    # values written over the same regions (8 B)
    res_bound = _bound(20 * n_log, 2 * n_log)
    if hop_ms is None or res_ms is None:
        raise AssertionError(f"[{tag}] the profiler recorded no P2 kernel")
    r_off = r_layout.out_off
    width = int((r_off[1:] - r_off[:-1]).max())
    padded = torch.zeros((b, width), device=DEV)
    lens = r_off[1:] - r_off[:-1]
    pos = torch.arange(width, device=DEV)
    valid = pos[None] < lens[:, None]
    padded[valid] = f32[(r_off[:-1, None] + pos[None])[valid]]
    got, want = (push_topk(r_ids, f32, r_off, k),
                 push_topk_plain(r_ids, f32, r_off, k))
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("push_topk (P2 form) differs from its plain "
                             "version")
    del got, want
    topk_ms = _time_ms(lambda: push_topk(r_ids, f32, r_off, k), 20)
    topk_plain = _time_ms(lambda: push_topk_plain(r_ids, f32, r_off, k), 3,
                          warmup=1)
    topk_lib = _time_ms(lambda: torch.topk(padded, k, dim=1), 20)
    topk_bound = _bound(8 * n_log + 8 * b * k, 2 * n_log)
    occ = bucket_push.occupancy()
    print(f"[{tag}] P2 block of {b}: every hop bit for bit its plain "
          f"version, the reserve table too; global-table share by hop "
          f"{shares}; largest hop {entries} entries, {slots} expansion "
          f"slots (at most {int(fr.exp.max())} a source), {out} next "
          f"entries, {layout.global_sources} sources ({table} table slots, "
          f"{table_ms} ms of their traffic at 24 B a slot, in no bound) "
          f"on the global table: bucket_hop ms (device) "
          f"{hop_ms} call_ms {hop_call} bound_ms {hop_bound[0]} "
          f"({hop_bound[1]}; {hop_sectors_ms} with the records as 32-byte "
          f"sectors); plain hop ms {hop_plain}; reserve log {n_log} entries "
          f"over {len(logs)} hops, {r_layout.global_sources} sources "
          f"({r_table} table slots, {r_table_ms} ms of their traffic) on "
          f"the global table: bucket_reserve ms (device) {res_ms} call_ms "
          f"{res_call} bound_ms {res_bound[0]} plain_ms {res_plain}; "
          f"push_topk ms {topk_ms} plain_ms {topk_plain} library_ms "
          f"{topk_lib} (torch.topk over the rows padded to {width}) "
          f"bound_ms {topk_bound[0]}; smem table {bucket_push.SMEM_SLOTS} "
          f"slots: {occ}", flush=True)
    shape = (f"block {b}, hop of {entries} entries, {slots} slots, {out} "
             f"out, {layout.global_sources} sources global")
    return {"bucket_hop": {"ms": hop_ms, "call_ms": hop_call,
                           "plain_ms": hop_plain, "bound_ms": hop_bound[0],
                           "bound_by": hop_bound[1],
                           "sectors_bound_ms": hop_sectors_ms,
                           "global_table_ms": table_ms,
                           "library_ms": None, "shape": shape,
                           "global_share_by_hop": shares,
                           **occ["bucket_hop"]},
            "bucket_reserve": {"ms": res_ms, "call_ms": res_call,
                               "plain_ms": res_plain,
                               "bound_ms": res_bound[0],
                               "global_table_ms": r_table_ms,
                               "bound_by": res_bound[1], "library_ms": None,
                               "shape": f"block {b}, log of {n_log} entries "
                                        f"over {len(logs)} hops, "
                                        f"{r_layout.global_sources} sources "
                                        f"global",
                               **occ["bucket_reserve"]},
            "push_topk": {"ms": topk_ms, "plain_ms": topk_plain,
                          "bound_ms": topk_bound[0],
                          "bound_by": topk_bound[1], "library_ms": topk_lib,
                          "shape": f"P2 reserve tables, {b} rows of "
                                   f"{n_log} slots, k {k}"}}


def _same(a, b) -> bool:
    return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def check_push(data, cfg, tag: str, backends) -> dict:
    """Phases 3e/3f: each device push from the sources ``train()`` builds
    (see :func:`check_push_graph`)."""
    return check_push_graph(add_self_loops_adj(data.adj),
                            train_sources(cfg, data), cfg, tag, backends)


def check_push_graph(adj_sl, sources, cfg, tag: str, backends,
                     spill: bool = False) -> dict:
    """Each device push from ``sources`` over ``adj_sl``, run through
    ``gfpush`` as a path, against native under the row rule, against its
    plain version on the card, and run twice (P2's peak device memory
    taken on the second run); then its kernel times on the first block
    (``spill``: P2's largest hop there must use the global table).
    Returns {kernel name: numbers} and each path's launches."""
    indptr = np.asarray(adj_sl.indptr, np.int32)
    indices = np.asarray(adj_sl.indices, np.int32)
    coef = np.asarray(build_coef(cfg.prop_mode, cfg.order, cfg.alpha),
                      np.float32)
    k, rmax = cfg.top_k, cfg.rmax
    atol = max(1e-5, 2 * rmax)
    # the first call compiles the native kernel (g++): not part of its rate
    gfpush_native(indptr, indices, sources[:1], coef, rmax, k)
    t0 = time.time()
    want = gfpush_native(indptr, indices, sources, coef, rmax, k)
    native_s = time.time() - t0
    print(f"[{tag}] {adj_sl.shape[0]} nodes, {adj_sl.nnz} nonzeros: ppr "
          f"order {cfg.order} alpha {cfg.alpha} "
          f"rmax {rmax} k {k}; native on {os.cpu_count()} host cores: "
          f"{len(sources)} sources in {native_s} s = "
          f"{len(sources) / native_s} sources/s", flush=True)
    out = {"native_sps": len(sources) / native_s,
           "host_cores": os.cpu_count(), "launches": {}, "sps": {}}
    for backend in backends:
        tk, launches, seconds = run_push_path(adj_sl, sources, cfg, backend,
                                              tag)
        out["launches"][backend] = launches
        out["sps"][backend] = len(sources) / seconds
        got = (tk.cols, tk.vals)
        out.setdefault("tables", {})[backend] = got
        _row_rule(want[0], want[1].astype(np.float32), *got, atol)
        if backend == "jax":
            g = dense_push.DensePushGraph(indptr, indices, rmax, device=DEV)
            again = dense_push.gfpush_dense(indptr, indices, sources, coef,
                                            rmax, k, device=DEV)
            run_block = dense_push.push_block
            block = 512
        else:
            g = bucket_push.BucketPushGraph(indptr, indices, rmax,
                                            device=DEV)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                again, peak = _peak_gb(lambda: bucket_push.gfpush_bucketed(
                    indptr, indices, sources, coef, rmax, k, graph=g))
            # the block the push settled on: 1,024, halved at each back-off
            halvings = sum("retrying at block=" in str(w.message)
                           for w in caught)
            block = 1024 >> halvings
            busy, wall = _busy_ms(lambda: bucket_push.gfpush_bucketed(
                indptr, indices, sources, coef, rmax, k, block=block,
                graph=g))
            out["peak_gb"] = peak
            out["busy_ms"] = {"device": busy, "wall": wall}
            print(f"[{tag}] bucket push: block {block} ({halvings} "
                  f"back-offs from 1024 over slot_limit); peak device memory "
                  f"{peak} GB above its graph's tables, back-offs included; "
                  f"a push at block {block} under the profiler: device busy "
                  f"{busy} ms of {wall} ms wall", flush=True)
            run_block = bucket_push.push_block
        plain = [[], []]
        for start in range(0, len(sources), block):
            src = torch.as_tensor(sources[start:start + block].astype(
                np.int32), device=DEV)
            for i, t in enumerate(run_block(g, src, coef, k, plain=True)):
                plain[i].append(t.cpu().numpy())
        plain = [np.concatenate(p) for p in plain]
        if not _same(got, again):
            raise AssertionError(f"[{tag}] two {backend} runs differ")
        err = float(np.abs(got[1] - plain[1]).max()) / float(
            np.abs(plain[1]).max())
        cols_equal = np.array_equal(got[0], plain[0])
        exact = _same(got, plain)
        print(f"[{tag}] {backend}: within {atol} of native under the row "
              f"rule; two runs identical; against its plain version on the "
              f"card: cols equal {cols_equal}, vals max_rel_err {err}, bit "
              f"for bit {exact}", flush=True)
        # P2 sums in fixed point: bit for bit; P1's K2 adds in edge order
        if not (exact if backend == "bucket" else
                (cols_equal and err <= TOL)):
            raise AssertionError(f"[{tag}] {backend} disagrees with its "
                                 f"plain version")
        src = torch.as_tensor(sources[:block].astype(np.int32), device=DEV)
        times = (_p1_times(g, src, coef, k) if backend == "jax" else
                 _p2_times(g, src, coef, k, tag, spill))
        out[backend] = {"max_abs_err": float(np.abs(got[1]
                                                    - plain[1]).max()),
                        "times": times}
        del g
    print(f"[{tag}] sources/s: native {out['native_sps']} ({os.cpu_count()} "
          f"host cores), card {out['sps']}", flush=True)
    return out


COUNTED = {"dropnode_mean": gather_and_prop, "csr_spmm_prop": spmm_prop_step,
           "csr_spmm_prop_bf16": spmm_prop_step_bf16,
           "quantize_columns": quantize_columns,
           "csr_spmm_q8": spmm_prop_step_q8,
           "csr_spmm_q8mxu": spmm_prop_step_q8mxu,
           "embed_prop_fwd": embed_prop,
           "embed_prop_bwd": embed_prop_backward,
           "embed_prop_window_fwd": embed_prop_window,
           "embed_prop_window_bwd": embed_prop_window_backward,
           "dense_push_mask": dense_push_mask,
           "bucket_hop": bucket_push.bucket_hop,
           "bucket_reserve": bucket_push.bucket_reserve,
           "push_topk": push_topk,
           "coo_spmm": spmm_segment_prop_step,
           "column_absmax": column_absmax,
           "quantize_with_amax": quantize_with_amax,
           "halo_pack": halo_pack,
           "halo_hop": halo_hop,
           "adam": adam_update}
HOP_KERNELS = ("csr_spmm_prop", "csr_spmm_prop_bf16", "quantize_columns",
               "quantize_with_amax", "csr_spmm_q8", "csr_spmm_q8mxu")
# K2-seg, the quantize split and D1's kernels: none of the training paths
# runs them
SERVE_KERNELS = ("coo_spmm", "column_absmax", "halo_pack", "halo_hop")
# the hop kernels of each form a Propagator's hops run
# (``Propagator.last_precision``; None on the dense backend)
PRECISION_KERNELS = {
    None: set(), "f32": {"csr_spmm_prop"}, "bf16": {"csr_spmm_prop_bf16"},
    "int8mxu": {"csr_spmm_q8mxu"}, "int8cast": {"csr_spmm_q8"}}


def hop_counts(precision, order: int) -> dict:
    """The launches of a propagation of ``order`` hops in ``precision``'s
    form: each hop kernel ``order`` times; an int8 form also one full
    quantize (its first hop) and ``order - 1`` one-launch quantizes on the
    maxima each hop raised for the next."""
    want = {k: order for k in PRECISION_KERNELS[precision]}
    if precision in ("int8mxu", "int8cast"):
        want.update(quantize_columns=1, quantize_with_amax=order - 1)
    return want


def _reset_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def _read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items()}


def _check_hops(launches: dict, precision, order: int) -> None:
    """The hop kernels of ``precision``'s form launched as
    :func:`hop_counts` says, the other hop kernels and the serving ones
    not at all."""
    selected = hop_counts(precision, order)
    for name in HOP_KERNELS + SERVE_KERNELS:
        want = selected.get(name, 0)
        if launches[name] != want:
            raise AssertionError(f"{name} launched {launches[name]} times, "
                                 f"expected {want} (order={order}, "
                                 f"expected {selected})")


def run_path(cfg, data, tag: str) -> tuple:
    """One ``train()`` of the path with every launch count set to 0 just
    before and read just after; returns (result, launches). The hop
    kernels of the form the predict's hops ran must launch ``order`` times
    each, the others not at all."""
    _reset_counts()
    torch.cuda.reset_peak_memory_stats(DEV)
    t0 = time.time()
    r = train(cfg, data=data, device=DEV)
    wall = time.time() - t0
    launches = _read_counts()
    print(f"[{tag}] {cfg.dataset}, {cfg.epochs} epochs, predict_precision "
          f"{cfg.predict_precision} (hops ran {r.predict_precision}): steps "
          f"{r.num_batches}, evals "
          f"{len(r.history)}, launches {launches}, "
          f"test_acc {r.test_acc}, best_val_acc {r.best_val_acc}, "
          f"preprocess_s {r.preprocess_time}, batch_time_median_s "
          f"{r.batch_time_median}, propagate_s {r.propagate_time}, total_s "
          f"{r.total_time}, train_call_s {wall}, peak_mem_GB "
          f"{torch.cuda.max_memory_allocated(DEV) / 1e9}", flush=True)
    PEAK_GB[tag] = torch.cuda.max_memory_allocated(DEV) / 1e9
    losses = [v for h in r.history for v in (h["loss"], h["val_loss"])]
    if not (r.history and np.all(np.isfinite(losses))):
        raise AssertionError(f"non-finite losses: {r.history}")
    if not 0.0 <= r.test_acc <= 1.0:
        raise AssertionError(f"test_acc {r.test_acc}")
    _check_hops(launches, r.predict_precision, cfg.order)
    if launches["adam"] != r.num_batches:
        raise AssertionError(f"Adam launched {launches['adam']} times, not "
                             f"once a step ({r.num_batches})")
    # the push kernels of the push backend, none for native (and 'auto',
    # which picks native at these source counts on a host with a core)
    pushers = PUSH_KERNELS.get(cfg.push_backend, set())
    for name in PUSH_COUNTED:
        if (launches[name] > 0) != (name in pushers):
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"with push_backend={cfg.push_backend!r}")
    return r, launches


def run_main_path(data) -> tuple:
    cfg = preset("reddit").replace(dataset=DATASET, epochs=2)
    r, launches = run_path(cfg, data, "main")
    if launches["dropnode_mean"] < r.num_batches + len(r.history):
        raise AssertionError("K1 was not launched for every step and eval")
    return launches, r


LONG_RUN_DIR = os.path.join("build", "chip_smoke_5g")
LONG_RUN_TIMEOUT = 300              # seconds the 5g child may take
K2_KERNEL = "csr_spmm_prop_kernel"  # K2's name in a profiler trace
# 5g's child: train() with the config given as JSON, the push's cols and
# vals digested as the trainer received them, and every checkpoint the
# loop writes (file, num_batch, seconds) in order; one JSON line on stdout.
# With a second argument N it sends itself SIGTERM during its Nth step.
_LONG_RUN_CHILD = """
import hashlib, json, os, signal, sys, time
from grandtpu_torch.config import GrandConfig
from grandtpu_torch.data import load_data
from grandtpu_torch.train import loop, trainer
cfg = GrandConfig(**json.loads(sys.argv[1]))
real, digests = trainer.push, []
def push(*args, **kwargs):
    tk = real(*args, **kwargs)
    digests.append(hashlib.sha256(tk.cols.tobytes() + tk.vals.tobytes())
                   .hexdigest())
    return tk
trainer.push = push
real_save, saves = loop.save_checkpoint, []
def save(path, **kwargs):
    t0 = time.time()
    real_save(path, **kwargs)
    saves.append([os.path.basename(path), kwargs["num_batch"],
                  time.time() - t0])
loop.save_checkpoint = save
if len(sys.argv) > 2:
    real_build, calls = trainer.build_train_step, [0]
    def build(*args, **kwargs):
        step = real_build(*args, **kwargs)
        def signalling(*a, **k):
            calls[0] += 1
            if calls[0] == int(sys.argv[2]):
                os.kill(os.getpid(), signal.SIGTERM)
            return step(*a, **k)
        return signalling
    trainer.build_train_step = build
r = trainer.train(cfg, data=load_data(cfg.dataset, split_seed=cfg.seed1),
                  device="cuda")
print(json.dumps({"preempted": r.preempted, "num_batches": r.num_batches,
                  "evals": len(r.history), "test_acc": r.test_acc,
                  "preprocess_time": r.preprocess_time,
                  "push_digest": digests[0], "saves": saves}))
"""


def _metrics_lines(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.endswith("\n")]


def _preempted_child(cfg, stop_step: int | None = None) -> tuple:
    """5g's first run: the child trains with ``cfg``; once its metrics file
    holds an eval line, SIGTERM (with ``stop_step``, the child signals
    itself during that step instead). Returns (its JSON result, the
    seconds from its start to the signal, its wall seconds)."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    child = subprocess.Popen(
        [sys.executable, "-c", _LONG_RUN_CHILD, json.dumps(fields),
         *([] if stop_step is None else [str(stop_step)])],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    sent = None if stop_step is None else "by itself"
    try:
        while (sent is None and child.poll() is None
               and time.time() - t0 < LONG_RUN_TIMEOUT):
            if any("val_acc" in ln for ln in _metrics_lines(
                    cfg.metrics_path)):
                child.send_signal(signal.SIGTERM)
                sent = time.time() - t0
                break
            time.sleep(0.02)
        out, err = child.communicate(
            timeout=max(LONG_RUN_TIMEOUT - (time.time() - t0), 1.0))
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    if child.returncode != 0 or sent is None:
        raise AssertionError(f"[5g] the child exited {child.returncode} "
                             f"(signal sent at {sent} s):\n{err[-4000:]}")
    return json.loads(out.strip().splitlines()[-1]), sent, time.time() - t0


def run_long_run(data, r_main) -> dict:
    """Phase 5g: the reddit path preempted in a child process, then resumed
    here as a path with the push cache, the metrics stream and a profile
    (see the module docstring)."""
    shutil.rmtree(LONG_RUN_DIR, ignore_errors=True)
    base = os.path.abspath(LONG_RUN_DIR)
    cfg = preset("reddit").replace(
        dataset=DATASET, epochs=20, ckpt_dir=os.path.join(base, "ck"),
        save_every=1, metrics_path=os.path.join(base, "metrics.jsonl"),
        push_cache_dir=os.path.join(base, "push_cache"),
        profile_dir=os.path.join(base, "profile"))
    first, sent, child_s = _preempted_child(cfg)
    latest = os.path.join(cfg.ckpt_dir, "latest.npz")
    with np.load(latest) as z:
        saved = json.loads(bytes(z["__meta__"]).decode())["num_batch"]
    events = [ln.get("event") for ln in _metrics_lines(cfg.metrics_path)]
    # save_every=1 writes latest.npz at every eval, so the preemption's own
    # save is the one beyond them: evals + 1 writes, the last at the stop
    latest_saves = [nb for name, nb, _ in first["saves"]
                    if name == "latest.npz"]
    print(f"[5g] child: SIGTERM {sent} s after its start (its first eval "
          f"line), exit 0 after {child_s} s, preempted {first['preempted']} "
          f"at num_batch {first['num_batches']} after {first['evals']} "
          f"evals, latest.npz num_batch {saved}, latest.npz writes "
          f"{latest_saves} (expected {first['evals']} at the evals and the "
          f"preemption's), metrics events {[e for e in events if e]}, "
          f"preprocess_s {first['preprocess_time']} (the push, a cache "
          f"miss), test_acc {first['test_acc']}", flush=True)
    if not (first["preempted"] and saved == first["num_batches"]
            and len(latest_saves) == first["evals"] + 1
            and latest_saves[-1] == saved
            and events.count("preempted") == 1):
        raise AssertionError(f"[5g] the preempted run: {first}, latest "
                             f"{saved}, events {events}")

    pushes, received, logs = [], [], []
    real_gfpush, real_push = push_cache.gfpush, trainer_mod.push
    push_cache.gfpush = lambda *a, **k: pushes.append(1) or real_gfpush(
        *a, **k)
    trainer_mod.push = lambda *a, **k: received.append(
        real_push(*a, **k)) or received[-1]
    traces = set(os.listdir(cfg.profile_dir))
    try:
        _reset_counts()
        r = train(cfg.replace(resume=True), data=data, device=DEV,
                  log=logs.append)
        launches = _read_counts()
    finally:
        push_cache.gfpush, trainer_mod.push = real_gfpush, real_push
    tk = received[0]
    digest = hashlib.sha256(tk.cols.tobytes() + tk.vals.tobytes()).hexdigest()
    lines = _metrics_lines(cfg.metrics_path)
    ends = [ln for ln in lines if ln.get("event") == "train_end"]
    new_traces = sorted(set(os.listdir(cfg.profile_dir)) - traces)
    with open(os.path.join(cfg.profile_dir, new_traces[-1])) as f:
        k2_in_trace = K2_KERNEL in f.read()
    first_eval = r.history[0]["batch"] if r.history else None
    print(f"[5g] resumed: {'resumed from' in ' '.join(map(str, logs))}, "
          f"first eval at batch {first_eval} (saved {saved}, eval_batch "
          f"{cfg.eval_batch}), steps to {r.num_batches}, launches "
          f"{launches}; pushes run {len(pushes)} (limit 0), cols and vals "
          f"as the child's {digest == first['push_digest']}; preprocess_s "
          f"{r.preprocess_time} (the child's {first['preprocess_time']}); "
          f"metrics: {sum('val_acc' in ln for ln in lines)} eval lines, "
          f"train_end train_edges_per_s {[e['train_edges_per_s'] for e in ends]}"
          f"; trace {new_traces[-1]} names {K2_KERNEL} "
          f"{k2_in_trace}; test_acc {r.test_acc} (the child's "
          f"{first['test_acc']}, phase 5's {r_main.test_acc})", flush=True)
    if not (first_eval is not None and saved <= first_eval
            < saved + cfg.eval_batch and not pushes
            and digest == first["push_digest"] and len(ends) == 2
            and all(e["train_edges_per_s"] > 0 for e in ends)
            and k2_in_trace and not r.preempted):
        raise AssertionError("[5g] the resumed run failed a check")
    _check_hops(launches, r.predict_precision, cfg.order)
    if any(launches[name] for name in PUSH_COUNTED):
        raise AssertionError(f"[5g] a push kernel launched: {launches}")
    if launches["dropnode_mean"] < len(r.history):
        raise AssertionError("[5g] K1 did not launch for every eval")
    return {"launches": launches, "cfg": cfg, "first": first,
            "history": r.history, "test_acc": r.test_acc,
            "digest": _digest(_replicas(r.model))}


def _disk_bytes(path: str) -> int:
    """The bytes of a file, or of the files of a directory."""
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def run_long_run_dir(data, npz_run: dict) -> dict:
    """Phase 5g-dir: 5g again with ``ckpt_backend="orbax"`` (the directory
    checkpoints ``best/`` and ``latest/``, torch.distributed.checkpoint's
    bytes): the child stops itself at 5g's stop step, the resume here is a
    path, and its history, test_acc and parameter digest are 5g's npz
    run's bit for bit (the same seeds and push); each form's save seconds
    and size on disk. Returns the resumed run's launches."""
    base = os.path.abspath(LONG_RUN_DIR)
    first_npz = npz_run["first"]
    stop = first_npz["num_batches"]
    cfg = npz_run["cfg"].replace(
        ckpt_dir=os.path.join(base, "ck_dir"), ckpt_backend="orbax",
        metrics_path=os.path.join(base, "metrics_dir.jsonl"),
        profile_dir=None)
    first, _, child_s = _preempted_child(cfg, stop_step=stop)
    ck = cfg.ckpt_dir
    forms = {name: os.path.isdir(os.path.join(ck, name))
             for name in ("best", "latest")}
    if not (first["preempted"] and first["num_batches"] == stop
            and all(forms.values())):
        raise AssertionError(f"[5g-dir] the preempted child: {first}, "
                             f"{sorted(os.listdir(ck))}")
    _, _, _, meta = load_checkpoint(os.path.join(ck, "latest.npz"),
                                    params_template={}, state_template={})
    logs = []
    _reset_counts()
    r = train(cfg.replace(resume=True), data=data, device=DEV,
              log=logs.append)
    launches = _read_counts()
    digest = _digest(_replicas(r.model))
    sizes = {"latest.npz": _disk_bytes(os.path.join(
        npz_run["cfg"].ckpt_dir, "latest.npz")),
        "latest/": _disk_bytes(os.path.join(ck, "latest")),
        "best.npz": _disk_bytes(os.path.join(npz_run["cfg"].ckpt_dir,
                                             "best.npz")),
        "best/": _disk_bytes(os.path.join(ck, "best"))}
    seconds = {form: {name: [t for n, _, t in run["saves"]
                             if n == f"{name}.npz"]
                      for name in ("best", "latest")}
               for form, run in (("npz", first_npz), ("dir", first))}
    print(f"[5g-dir] child: stopped itself in step {stop} (5g's stop), exit "
          f"0 after {child_s} s, preempted {first['preempted']} at num_batch "
          f"{first['num_batches']}; best/ and latest/ directories {forms}, "
          f"latest/ num_batch {meta['num_batch']}; save seconds a call "
          f"{seconds}; bytes on disk {sizes}; resumed: "
          f"{'resumed from' in ' '.join(map(str, logs))}, steps to "
          f"{r.num_batches}, launches {launches}; push as 5g's "
          f"{first['push_digest'] == first_npz['push_digest']}; history as "
          f"5g's "
          f"{r.history == npz_run['history']}, test_acc {r.test_acc} (5g "
          f"{npz_run['test_acc']}), parameter digest as 5g's "
          f"{digest == npz_run['digest']}", flush=True)
    if not (meta["num_batch"] == stop and r.history == npz_run["history"]
            and first["push_digest"] == first_npz["push_digest"]
            and r.test_acc == npz_run["test_acc"]
            and digest == npz_run["digest"] and not r.preempted):
        raise AssertionError("[5g-dir] the resumed run differs from 5g's")
    _check_hops(launches, r.predict_precision, cfg.order)
    if launches["dropnode_mean"] < len(r.history) or not launches["adam"]:
        raise AssertionError(f"[5g-dir] launches {launches}")
    return launches


SCAN_EPOCHS = 10
# 5h: the group lengths grandtpu's policy rolls in a SCAN_EPOCHS run and how
# many groups of each (reddit: 17 steps an epoch, an eval every 10; MAG: 8
# steps an epoch; grandtpu/train/loop.py:214-222)
SCAN_ROLLED = {"reddit": {10: 6}, "mag": {3: 2, 7: 2}}
SCAN_GROUP = {"dense": 10, "mag": 7}   # the group held to its eager steps


def _scan_launches(engine: str, r, launches: dict, chunks: int) -> None:
    """K1 once a step and eval (dense), K3's forward once a step, eval and
    predict chunk and its backward once a step (MAG); Adam once a step."""
    steps, evals = r.num_batches, len(r.history)
    want = ({"dropnode_mean": steps + evals} if engine == "dense" else
            {"embed_prop_fwd": steps + evals + chunks,
             "embed_prop_bwd": steps})
    want["adam"] = steps
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"[5h] {name} launched {launches[name]} "
                                 f"times, not {n} ({steps} steps, {evals} "
                                 f"evals)")


def _history_diff(a, b) -> dict:
    return {k: max(abs(x[k] - y[k]) for x, y in zip(a.history, b.history))
            for k in ("val_loss", "val_acc", "loss")}


def run_scan_pair(name: str, data) -> dict:
    """Phase 5h's pair: ``train()`` per step, then with ``scan_steps``,
    each a path (counts set to 0 before, read after); between them the
    per-step run once more, whose differences from the first are the runs'
    own spread."""
    engine = "dense" if name == "reddit" else "mag"
    cfg = preset("mag_scholar_c" if engine == "mag" else "reddit").replace(
        dataset=MAG_DATASET if engine == "mag" else DATASET,
        epochs=SCAN_EPOCHS)
    chunks = -(-data.num_nodes // K3_SHAPE[4])
    runs = {}
    for scan in (False, "again", True):
        _reset_counts()
        torch.cuda.reset_peak_memory_stats(DEV)
        t0 = time.time()
        r = train(cfg.replace(scan_steps=scan is True), data=data, device=DEV)
        wall = time.time() - t0
        launches = _read_counts()
        peak = torch.cuda.max_memory_allocated(DEV) / 1e9
        _scan_launches(engine, r, launches, chunks)
        runs[scan] = {"r": r, "launches": launches, "wall_s": wall,
                      "peak_GB": peak}
        print(f"[5h] {name} scan_steps={scan}: steps {r.num_batches}, evals "
              f"{len(r.history)}, test_acc {r.test_acc}, "
              f"batch_time_median_s {r.batch_time_median}, synchronized s "
              f"a step {r.batch_time_synced}, train_call_s {wall}, "
              f"peak_mem_GB {peak}, rolled groups {r.scan_groups}, launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    per, rolled = runs[False]["r"], runs[True]["r"]
    got = {k: (s["runs"], s["graph"]) for k, s in rolled.scan_groups.items()}
    want = {k: (n, DEV.type == "cuda")
            for k, n in SCAN_ROLLED[name].items()}
    if got != want or per.scan_groups:
        raise AssertionError(f"[5h] rolled groups {got}, expected {want} "
                             f"(per step: {per.scan_groups})")
    for k, s in rolled.scan_groups.items():
        kernels = ({"gather_and_prop": k} if engine == "dense" else
                   {"embed_prop": k, "embed_prop_backward": k})
        kernels["adam_update"] = k
        if DEV.type == "cuda" and s["launches"] != kernels:
            raise AssertionError(f"[5h] a replay of length {k} adds "
                                 f"{s['launches']}, not {kernels}")
    if rolled.num_batches != per.num_batches or len(rolled.history) != len(
            per.history):
        raise AssertionError(f"[5h] {rolled.num_batches} steps and "
                             f"{len(rolled.history)} evals against "
                             f"{per.num_batches} and {len(per.history)}")
    again = runs["again"]["r"]
    diff = _history_diff(rolled, per)
    n_test = len(data.idx_test)
    bits = rolled.history == per.history
    nodes = round(abs(rolled.test_acc - per.test_acc) * n_test)
    spread = {"history_bit_for_bit": again.history == per.history,
              "max_diff": _history_diff(again, per),
              "test_nodes": round(abs(again.test_acc - per.test_acc)
                                  * n_test)}
    print(f"[5h] {name} scan_steps against per step: history bit for bit "
          f"{bits}, largest differences {diff}; test_acc "
          f"{rolled.test_acc} against {per.test_acc} ({nodes} of {n_test} "
          f"test nodes; the per-step run against itself: {spread}); "
          f"steps a second "
          f"(host, batch_time_median) {1 / rolled.batch_time_median} against "
          f"{1 / per.batch_time_median}; synchronized ms a step "
          f"{rolled.batch_time_synced * 1e3} against "
          f"{per.batch_time_synced * 1e3}; graph pools "
          f"{sum(s['pool_bytes'] for s in rolled.scan_groups.values()) / 1e9}"
          f" GB, peak memory {runs[True]['peak_GB']} GB against "
          f"{runs[False]['peak_GB']} GB", flush=True)
    if not bits or rolled.test_acc != per.test_acc:
        raise AssertionError(f"[5h] the scan_steps run is not the per-step "
                             f"run: history bit for bit {bits} (largest "
                             f"differences {diff}), test_acc "
                             f"{rolled.test_acc} against {per.test_acc}")
    return {"bit_for_bit": bits, "max_diff": diff, "test_nodes": nodes,
            "per_step_spread": spread,
            "test_acc": [per.test_acc, rolled.test_acc],
            "batch_time_median_s": [per.batch_time_median,
                                    rolled.batch_time_median],
            "synced_s_a_step": [per.batch_time_synced,
                                rolled.batch_time_synced],
            "peak_GB": [runs[False]["peak_GB"], runs[True]["peak_GB"]],
            "pool_bytes": {k: s["pool_bytes"]
                           for k, s in rolled.scan_groups.items()},
            "capture_s": {k: s["capture_s"]
                          for k, s in rolled.scan_groups.items()},
            "rolled": {k: s["runs"] for k, s in rolled.scan_groups.items()},
            "launches": [runs[False]["launches"], runs[True]["launches"]]}


def _train_state(model, opt, gen) -> dict:
    """Copies of the model's parameters and buffers, the Adam state (the
    moments and the step count) and the generator's state."""
    out = {f"model.{k}": v.detach().clone()
           for k, v in model.state_dict().items()}
    for i, p in enumerate(model.parameters()):
        for key, v in opt.state.get(p, {}).items():
            out[f"adam.{i}.{key}"] = v.detach().clone()
    out["adam.count"] = opt.count.clone()
    out["generator"] = gen.get_state()
    return out


def _load_train_state(model, opt, gen, saved: dict) -> None:
    """:func:`_train_state`'s copies back, in place."""
    model.load_state_dict({k[len("model."):]: v for k, v in saved.items()
                           if k.startswith("model.")})
    for i, p in enumerate(model.parameters()):
        for key, v in opt.state.get(p, {}).items():
            v.copy_(saved[f"adam.{i}.{key}"])
    opt.count.copy_(saved["adam.count"])
    gen.set_state(saved["generator"])


def check_group(engine: str, data, padded=None) -> dict:
    """Phase 5h's group check: a ``StepGroup`` of SCAN_GROUP[engine] steps
    (captured, then replayed) against the same steps run eagerly from one
    saved state, at full width with the step's drop rates on; the
    wrappers' counts after the first and second call; synchronized times
    of the group and of its eager steps."""
    n_class = data.num_classes
    cfg, _, _, operands, mcfg, _ = _step_inputs(engine, data, padded)
    k = SCAN_GROUP[engine]
    torch.backends.cuda.matmul.allow_tf32 = False
    model = (init_mlp if engine == "dense" else init_mag_mlp)(mcfg, cfg.seed2,
                                                              DEV)
    opt = make_optimizer(model, cfg.lr, cfg.weight_decay)
    if engine == "dense":
        step = build_train_step(StepConfig(
            mlp=mcfg, k_aug=cfg.sample, dropnode_rate=cfg.dropnode_rate,
            n_train=cfg.batch_size, lam=cfg.lam, warmup=cfg.warmup,
            tem=cfg.tem, conf=cfg.resolve_conf(n_class), loss_kind=cfg.loss,
            clip_norm=cfg.clip_norm), model, opt)
    else:
        step = build_sparse_steps(cfg, model, opt, n_class)[0]
    gen = torch.Generator(device=DEV).manual_seed(cfg.seed2)
    g = torch.Generator(device=DEV).manual_seed(4)
    n_src = operands[-1].shape[0]
    batches = [_mesh_batch(cfg, n_src, n_class, g) for _ in range(k + 2)]
    epoch = {name: torch.stack([b[name] for b in batches])
             for name in batches[0]}
    # inside the warmup ramp: every step reads its own index
    nbs = torch.arange(100, 102 + k, dtype=torch.float32, device=DEV)

    def step_fn(batch, nb):
        return step(*operands, batch, gen, nb)

    def eager(i0: int):
        for i in range(i0, i0 + k):
            loss = step_fn({n: t[i] for n, t in epoch.items()}, nbs[i])["loss"]
        return loss

    # two eager steps first: Adam's state, the kernels' first launches
    for i in range(2):
        step_fn({n: t[i] for n, t in epoch.items()}, nbs[i])
    saved = _train_state(model, opt, gen)
    want_loss = float(eager(2))
    torch.cuda.synchronize(DEV)
    want = _train_state(model, opt, gen)
    _load_train_state(model, opt, gen, saved)
    rest = {n: t[2:] for n, t in epoch.items()}
    group = loop_mod.StepGroup(k, step_fn, rest, DEV, (gen,))
    _reset_counts()
    got_loss = float(group(rest, nbs[2:], 0))
    torch.cuda.synchronize(DEV)
    first = _read_counts()
    got = _train_state(model, opt, gen)
    group(rest, nbs[2:], 0)
    second = _read_counts()
    kernels = (("dropnode_mean", "adam") if engine == "dense" else
               ("embed_prop_fwd", "embed_prop_bwd", "adam"))
    for name in kernels:
        if first[name] != k or second[name] != 2 * k:
            raise AssertionError(f"[5h] {name} counted {first[name]} after "
                                 f"the capture and a replay, {second[name]} "
                                 f"after another, not {k} and {2 * k}")
    if int(opt.count) != int(saved["adam.count"]) + 2 * k:
        raise AssertionError(f"[5h] Adam's count {int(opt.count)} after the "
                             f"capture's replay and another, not "
                             f"{int(saved['adam.count'])} + 2 x {k}")
    errs = {}
    for key, w in want.items():
        if key == "generator":
            errs[key] = 0.0 if torch.equal(got[key], w) else float("inf")
        else:
            errs[key] = _errors(got[key], w)[1]
    errs["loss"] = abs(got_loss - want_loss) / max(abs(want_loss), 1e-30)
    worst = max(errs, key=errs.get)
    group_ms = _synced_ms(lambda: group(rest, nbs[2:], 0), 5) / k
    eager_ms = _synced_ms(lambda: eager(2), 5) / k
    print(f"[5h] one captured {engine} group of {k} steps against its eager "
          f"steps from one state ({len(errs)} quantities: parameters, "
          f"buffers, Adam, the generator): worst {worst} {errs[worst]} "
          f"(bit for bit wanted); generator state equal "
          f"{errs['generator'] == 0.0}; counts after the first call "
          f"{ {n: first[n] for n in kernels} }, after the second "
          f"{ {n: second[n] for n in kernels} }; graph pool "
          f"{group.pool_bytes / 1e9} GB, captured in {group.capture_s} s "
          f"(host); synchronized ms a step: replayed "
          f"{group_ms}, eager {eager_ms}", flush=True)
    if errs[worst] > 0.0:
        raise AssertionError(f"[5h] the {engine} group differs from its "
                             f"eager steps: {errs}")
    return {"max_rel_err": errs[worst], "replay_ms_a_step": group_ms,
            "eager_ms_a_step": eager_ms, "pool_bytes": group.pool_bytes,
            "capture_s": group.capture_s}


def run_mag_path(data) -> dict:
    cfg = preset("mag_scholar_c").replace(dataset=MAG_DATASET, epochs=5)
    r, launches = run_path(cfg, data, "mag")
    _check_k3_launches(r, launches, data)
    return launches


MAG_CKPT_DIR = os.path.join("build", "chip_smoke_mag_ckpt")


def _timed(fn, *args, **kwargs) -> tuple:
    t0 = time.time()
    out = fn(*args, **kwargs)
    return out, time.time() - t0


def run_mag_checkpoints(data) -> dict:
    """Phase 5i: the MAG path (mag_scholar_c, 1 epoch: one eval) with
    ``save_every=1`` and ``ckpt_backend="orbax"``, a path: ``latest/``
    holds the [2780000, 64] table with Adam's ``mu`` and ``nu``. The last
    ``latest`` save's trees, as the loop handed them over, against
    ``latest/`` restored: every leaf bit for bit. The same trees saved as
    ``latest.npz`` and loaded: its arrays the directory's bit for bit;
    save and load seconds and bytes on disk of both forms (DCP fsyncs its
    files, ``np.savez`` does not). Returns the launches."""
    shutil.rmtree(MAG_CKPT_DIR, ignore_errors=True)
    ck = os.path.abspath(MAG_CKPT_DIR)
    cfg = preset("mag_scholar_c").replace(
        dataset=MAG_DATASET, epochs=1, ckpt_dir=ck, save_every=1,
        ckpt_backend="orbax")
    calls, last = [], {}
    real = loop_mod.save_checkpoint

    def timed_save(path, **kwargs):
        _, dt = _timed(real, path, **kwargs)
        calls.append((os.path.basename(path), dt))
        if os.path.basename(path) == "latest.npz":
            last.clear()        # a copy: on the CPU the leaves alias
            last.update(copy.deepcopy(kwargs))     # the live parameters

    loop_mod.save_checkpoint = timed_save
    try:
        _reset_counts()
        r = train(cfg, data=data, device=DEV)
        launches = _read_counts()
    finally:
        loop_mod.save_checkpoint = real
    _check_k3_launches(r, launches, data)
    trees = {k: last[k] for k in ("params", "state", "opt_state")}
    want = {f"{n}|{k}": v for n, t in trees.items()
            for k, v in _flatten_with_paths(t).items()}
    latest = os.path.join(ck, "latest")
    got, load_dir_s = _timed(load_checkpoint, latest,
                             params_template=trees["params"],
                             state_template=trees["state"],
                             opt_template=trees["opt_state"])
    flat = {f"{n}|{k}": v for n, t in zip(trees, got[:3])
            for k, v in _flatten_with_paths(t).items()}
    same = sorted(flat) == sorted(want) and all(
        flat[k].dtype == want[k].dtype and np.array_equal(flat[k], want[k])
        for k in want)
    table = [k for k in want if "['table']" in k]
    npz_path = os.path.join(ck, "latest_again.npz")
    _, save_npz_s = _timed(save_checkpoint, npz_path,
                           **{**last, "backend": "npz"})
    _, save_dir_s = _timed(save_checkpoint, os.path.join(ck, "latest_again"),
                           **last)
    arrays = _load_directory(latest)
    with np.load(npz_path) as z:
        t0 = time.time()
        from_npz = {k: z[k] for k in z.files}
        load_npz_s = time.time() - t0
    same_npz = sorted(from_npz) == sorted(arrays) and all(
        np.array_equal(from_npz[k], arrays[k]) for k in arrays)
    sizes = {"latest/": _disk_bytes(latest),
             "latest.npz": _disk_bytes(npz_path)}
    print(f"[5i] MAG train() with save_every=1 and ckpt_backend 'orbax': "
          f"{r.num_batches} steps, {len(r.history)} evals; saves (name, s) "
          f"{calls}; latest/ at num_batch {got[3]['num_batch']}: "
          f"{', '.join(f'{k} {list(want[k].shape)}' for k in table)}, "
          f"{sizes['latest/']} bytes; restored bit for bit the loop's "
          f"trees {same}; the same trees as latest.npz "
          f"({sizes['latest.npz']} bytes) bit for bit {same_npz}; seconds: "
          f"save dir {save_dir_s} (in the loop "
          f"{[t for n, t in calls if n == 'latest.npz']}), load dir "
          f"{load_dir_s}; save npz {save_npz_s}, load npz {load_npz_s}; "
          f"launches {launches}", flush=True)
    if not (same and same_npz and len(table) == 3
            and all(want[k].shape == (data.features.shape[1], H_MAG)
                    for k in table)
            and got[3]["num_batch"] == last["num_batch"]):
        raise AssertionError("[5i] the directory checkpoint's restore")
    return launches


def _check_k3_launches(r, launches: dict, data) -> None:
    """A MAG path's K3: the forward once a step, eval and predict chunk,
    the backward once a step."""
    chunks = -(-data.num_nodes // K3_SHAPE[4])
    if launches["embed_prop_fwd"] != r.num_batches + len(r.history) + chunks:
        raise AssertionError(
            f"K3 forward launched {launches['embed_prop_fwd']} times, not "
            f"once per step, eval and predict chunk ({r.num_batches} + "
            f"{len(r.history)} + {chunks})")
    if launches["embed_prop_bwd"] != r.num_batches:
        raise AssertionError(f"K3 backward launched "
                             f"{launches['embed_prop_bwd']} times, not once "
                             f"per step ({r.num_batches})")


def profile_path(cfg, data, tag: str) -> None:
    """The path once more under torch.profiler: device time by kernel and
    the device's busy share of the ``train()`` call. Only device activity
    is traced: recording every host op as well cost seconds a path."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        r = train(cfg, data=data, device=DEV)
        torch.cuda.synchronize(DEV)
        wall_ms = (time.time() - t0) * 1e3
    # device events, without the user-annotation ranges (such as
    # Optimizer.step) that span other kernels
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        print(f"[{tag}] the profiler recorded no device time")
        return
    by_name: dict[str, list] = {}
    for e in kernels:
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += e.time_range.elapsed_us() / 1e3
        entry[1] += 1
    busy_ms = sum(t for t, _ in by_name.values())
    copy_ms = sum(t for k, (t, _) in by_name.items()
                  if k.startswith(("Memcpy", "Memset")))
    span_ms = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels)) / 1e3
    print(f"[{tag}] train() {wall_ms} ms wall (profiled), device busy "
          f"{busy_ms} ms = {100 * busy_ms / wall_ms}% of wall (copies "
          f"{copy_ms} ms, kernels {busy_ms - copy_ms} ms), first to last "
          f"device event {span_ms} ms, {len(kernels)} device events, "
          f"{r.num_batches} steps; batch_time_median_s "
          f"{r.batch_time_median}")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for i, (name, (t, n)) in enumerate(ranked):
        if i < 14 or any(k in name for k in ("dropnode_mean", "csr_spmm",
                                             "embed_prop", "quantize",
                                             "column_absmax", "adam_kernel")):
            print(f"[{tag}] {t:10.4f} ms {n:6d}x {name[:100]}")
    _adam_share(tag, kernels)


def _adam_share(tag: str, kernels) -> None:
    """The Adam kernel's share of a profiled train()'s steps: its device
    time a launch against the device time a step between the end of the
    first Adam launch and the end of the last (the later steps and their
    evals)."""
    adam = sorted((e for e in kernels if "adam_kernel" in e.name),
                  key=lambda e: e.time_range.start)
    if len(adam) < 2:
        print(f"[{tag}] the profiler recorded {len(adam)} Adam launches")
        return
    lo, hi = adam[0].time_range.end, adam[-1].time_range.end
    busy = sum(e.time_range.elapsed_us() for e in kernels
               if lo < e.time_range.start and e.time_range.end <= hi) / 1e3
    step_ms = busy / (len(adam) - 1)
    adam_ms = sum(e.time_range.elapsed_us() for e in adam) / 1e3 / len(adam)
    print(f"[{tag}] the Adam kernel: {adam_ms} ms a launch ({len(adam)} "
          f"launches), against {step_ms} ms of device time a step (the "
          f"{len(adam) - 1} steps after the first, their evals included): "
          f"{100 * adam_ms / step_ms:.1f} % of the step", flush=True)


def push_entries(push_reddit: dict, push_amazon: dict, push_hub: dict,
                 bucket_launches: dict, sharded: dict) -> list:
    """The kernels line's entries of the push kernels: times at the main
    path's shapes (P2 and its top-k at the Amazon2M stand-in, 3f, with
    3e's and 3k's beside them; P1's mask at the reddit stand-in, 3e),
    launches by path."""
    paths = {"amazon_bucket": bucket_launches,
             "p1_reddit": push_reddit["launches"]["jax"],
             "p2_reddit": push_reddit["launches"]["bucket"],
             "p2_amazon": push_amazon["launches"]["bucket"],
             "p2_hub": push_hub["launches"]["bucket"],
             "p1_sharded_reddit": sharded["launches"]}
    p1, p2 = push_reddit["jax"], push_amazon["bucket"]
    p2_err = max(p2["max_abs_err"], push_reddit["bucket"]["max_abs_err"],
                 push_hub["bucket"]["max_abs_err"])
    rows = [("dense_push_mask", "push_dense.cu", "grandtpu/ppr/jax_push.py:36",
             p1["times"]["dense_push_mask"], p1["max_abs_err"]),
            ("bucket_hop", "push_bucket.cu",
             "grandtpu/ppr/bucket_push.py:141",
             p2["times"]["bucket_hop"], p2_err),
            ("bucket_reserve", "push_bucket.cu",
             "grandtpu/ppr/bucket_push.py:329,262",
             p2["times"]["bucket_reserve"], p2_err),
            ("push_topk", "push_topk.cu", "grandtpu/ppr/bucket_push.py:262",
             p2["times"]["push_topk"], max(p2_err, p1["max_abs_err"]))]
    entries = []
    for name, src, line, times, err in rows:
        by_path = {p: la[name] for p, la in paths.items() if la[name]}
        entry = {"name": name, "route": "cuda",
                 "source": f"grandtpu_torch/csrc/{src}", "replaces": line,
                 "launches": sum(by_path.values()),
                 "launches_by_path": by_path, "max_abs_err": err, **times}
        if name in ("bucket_hop", "bucket_reserve"):
            entry["reddit"] = push_reddit["bucket"]["times"][name]
            entry["hub"] = push_hub["bucket"]["times"][name]
        if name == "push_topk":
            entry["p1_form"] = p1["times"]["push_topk"]
            entry["p1_library_ms"] = p1["times"]["push_topk"]["library_ms"]
        entries.append(entry)
    for key, res in (("reddit", push_reddit), ("amazon", push_amazon),
                     ("hub", push_hub)):
        entries[-1].setdefault("sources_per_s", {})[key] = {
            "native": res["native_sps"], "host_cores": res["host_cores"],
            **res["sps"]}
        if "peak_gb" in res:
            entries[-1].setdefault("p2_peak_gb", {})[key] = res["peak_gb"]
            entries[-1].setdefault("p2_busy_ms", {})[key] = res["busy_ms"]
    entries[-1]["sources_per_s"]["reddit"]["jax_sharded_4"] = \
        sharded["sources_per_s"]
    return entries

def _peak_gb(fn):
    """(result, peak device memory of ``fn()`` above what was allocated
    before it, in GB)."""
    torch.cuda.synchronize(DEV)
    base = torch.cuda.memory_allocated(DEV)
    torch.cuda.reset_peak_memory_stats(DEV)
    out = fn()
    torch.cuda.synchronize(DEV)
    return out, (torch.cuda.max_memory_allocated(DEV) - base) / 1e9


def check_segment(ops: dict) -> dict:
    """Phase 3g: K2-seg at the Amazon2M shape, hop by hop against its plain
    version (the fused hop and the bare product); the segment Propagator
    as a path against the csr backend's f32 run, with both runs' peak
    memory; times and the bounds of the hop, the product and the run."""
    cfg = preset("Amazon2M")
    adj, x, csr = ops["adj"], ops["x"], ops["f32"]
    kw = dict(mode="ppr", order=cfg.order, alpha=cfg.alpha)
    t0 = time.time()
    seg, build_gb = _peak_gb(lambda: Propagator(adj, backend="segment",
                                                device=DEV))
    build_s = time.time() - t0
    padded = seg.adj_op
    plan = padded.plan
    n, nfeat = x.shape
    e_pad = padded.num_edges_padded
    scale = 1.0 - cfg.alpha
    # rows under the split cap add in edge order as the plain version
    # does: bit for bit; a split row's chunks too, but held at TOL
    whole = torch.ones(n, dtype=torch.bool, device=DEV)
    if plan is not None:
        whole[plan.rows.long()] = False
    cur, acc, worst, differ = cfg.alpha * x, cfg.alpha * x, (0.0, 0.0), 0
    for _ in range(cfg.order):
        got_y, got_acc = torch.empty_like(cur), acc.clone()
        spmm_segment_prop_step(padded, cur, got_y, got_acc, scale, True)
        torch.cuda.synchronize(DEV)
        want_y, want_acc = torch.empty_like(cur), acc.clone()
        spmm_segment_prop_step_plain(padded, cur, want_y, want_acc, scale,
                                     True)
        for got, want in ((got_y, want_y), (got_acc, want_acc)):
            e = _errors(got, want)
            worst = (max(worst[0], e[0]), max(worst[1], e[1]))
            differ += int((got[whole] != want[whole]).sum())
        cur, acc = want_y, want_acc
        del got_y, got_acc
    bare = spmm_segment(padded, cur)
    bare_differ = int((bare != spmm_segment_plain(padded, cur)).sum())
    del cur, acc, bare
    print(f"[3g] coo_spmm: {cfg.order} fused ppr hops "
          f"(spmm_segment_prop_step) at [{n},{nfeat}], {e_pad} padded "
          f"edges, {0 if plan is None else plan.num_chunks} chunks, one at "
          f"a time on a shared input: max_abs_err {worst[0]} max_rel_err "
          f"{worst[1]} (limit {TOL}), elements of rows under the split cap "
          f"differing {differ} (limit 0: bit for bit); the bare product "
          f"(spmm_segment) elements differing {bare_differ} (limit 0)",
          flush=True)
    if not (worst[1] <= TOL and differ == 0 and bare_differ == 0):
        raise AssertionError(f"coo_spmm disagrees with its plain version: "
                             f"{worst[1]} > {TOL} or {differ}, "
                             f"{bare_differ} elements differ")
    ref, csr_gb = _peak_gb(lambda: csr(x, **kw))
    _reset_counts()
    out, seg_gb = _peak_gb(lambda: seg(x, **kw))
    launches = _read_counts()
    err = _errors(out, ref)
    struct_csr = 4 * (n + 1) + 8 * csr.adj_op.nnz
    struct_seg = 12 * e_pad
    print(f"[3g] Propagator(backend='segment') {cfg.order} ppr hops: "
          f"launches {launches}; against the csr backend's f32 run "
          f"max_abs_err {err[0]} max_rel_err {err[1]} (limit {TOL}); peak "
          f"device memory above the resident operands: segment {seg_gb} GB, "
          f"csr {csr_gb} GB; operator structure segment {struct_seg / 1e9} "
          f"GB, csr {struct_csr / 1e9} GB; segment build {build_s} s "
          f"({build_gb} GB)", flush=True)
    bad = {k: v for k, v in launches.items()
           if v != (cfg.order if k == "coo_spmm" else 0)}
    if bad or not err[1] <= TOL:
        raise AssertionError(f"segment path: launches {bad}, err {err}")
    del out, ref
    x0 = cfg.alpha * x
    y, acc = torch.empty_like(x0), x0.clone()
    ms = _time_ms(lambda: spmm_segment_prop_step(padded, x0, y, acc, scale,
                                                 True), 30)
    plain_ms = _time_ms(lambda: spmm_segment_prop_step_plain(
        padded, x0, y, acc, scale, True), 3, warmup=1)
    bare_ms = _time_ms(lambda: spmm_segment(padded, x0, out=y), 30)
    run_ms = _time_ms(lambda: seg(x, **kw), 10)
    a = torch.sparse_coo_tensor(
        torch.stack([padded.rows.long(), padded.cols.long()]), padded.vals,
        (n + 1, n)).coalesce()
    library_ms = _time_ms(lambda: torch.sparse.mm(a, x0), 30)
    del a, y, acc
    flops = 2 * csr.adj_op.nnz * nfeat
    # the fused hop: each padded edge's 12 bytes, x read, acc read, y and
    # acc written; the bare product: x read, y written
    nbytes = 12 * e_pad + 16 * n * nfeat
    bound_ms, bound_by = _bound(nbytes, flops + 2 * n * nfeat)
    bare_bytes = 12 * e_pad + 8 * n * nfeat
    bare_bound = _bound(bare_bytes, flops)
    print(f"[3g] coo_spmm fused hop at [{n},{nfeat}]: ms {ms} (the update "
          f"apart, on an H100 80GB HBM3 at 700 W: 3.268 = fill 0.246 + "
          f"kernel 1.708 + mul_ 0.532 + add_ 0.778) plain_ms {plain_ms} "
          f"bound_ms {bound_ms} ({bound_by}, {nbytes / 1e9:.3f} GB, "
          f"{bound_ms / ms:.1%} of it); the bare product ms {bare_ms} "
          f"(1.958 with a zero-fill) bound_ms {bare_bound[0]} "
          f"({bare_bytes / 1e9:.3f} GB, {bare_bound[0] / bare_ms:.1%}) "
          f"library_ms {library_ms} (torch.sparse.mm, coalesced COO, A x "
          f"only); the whole {cfg.order}-hop run ms {run_ms} (the update "
          f"apart: 21.179), {cfg.order} x the hop's bound "
          f"{cfg.order * bound_ms}", flush=True)
    return {"name": "coo_spmm", "route": "cuda",
            "source": "grandtpu_torch/csrc/coo_spmm.cu",
            "replaces": "grandtpu/sparse/spmm.py:74",
            "max_abs_err": worst[0], "max_rel_err": worst[1],
            "elements_differing_under_cap": differ, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "shape": f"x [{n},{nfeat}], {e_pad} padded edges, per fused "
                     "hop (spmm_segment_prop_step)",
            "bare": {"ms": bare_ms, "bound_ms": bare_bound[0],
                     "bound_by": bare_bound[1],
                     "elements_differing": bare_differ},
            "run_ms": run_ms,
            "launches_by_path": {"segment": launches["coo_spmm"]},
            "peak_extra_GB": {"segment": seg_gb, "csr": csr_gb},
            "propagate_vs_csr_max_rel_err": err[1]}


def _bf16_hops(padded, x0: torch.Tensor, scale: float, order: int) -> tuple:
    """K2-seg's bf16-carry form against its plain version, ``order`` fused
    ppr hops one at a time on a shared input (each takes the plain hop's
    output): (elements differing, the largest difference in bf16 ulps,
    the largest |got - want|), y and acc of every row."""
    cur, acc, differ, ulps, worst = x0, x0.clone(), 0, 0.0, 0.0
    for _ in range(order):
        got_y, got_acc = torch.empty_like(cur), acc.clone()
        spmm_segment_prop_step(padded, cur, got_y, got_acc, scale, True)
        torch.cuda.synchronize(DEV)
        want_y, want_acc = torch.empty_like(cur), acc.clone()
        spmm_segment_prop_step_plain(padded, cur, want_y, want_acc, scale,
                                     True)
        for got, want in ((got_y, want_y), (got_acc, want_acc)):
            differ += int((got != want).sum())
            ulps = max(ulps, bf16_ulps(got, want))
            worst = max(worst, float((got.float() - want.float()).abs()
                                     .max()))
        cur, acc = want_y, want_acc
        del got_y, got_acc
    return differ, ulps, worst


def check_segment_bf16(ops: dict, seg: dict) -> dict:
    """Phase 3g, bf16 carries: K2-seg's bf16-carry form hop by hop against
    its plain version (every element bit for bit), the segment backend's
    bf16_carry run as a path against the csr f32 run and beside the f32
    segment run (``seg``, :func:`check_segment`'s entry) and the csr
    bf16_carry run; the hop's times and bound."""
    cfg = preset("Amazon2M")
    adj, x = ops["adj"], ops["x"]
    kw = dict(mode="ppr", order=cfg.order, alpha=cfg.alpha)
    t0 = time.time()
    (prop, precision), build_gb = _peak_gb(
        lambda: propagate_mod.exact_propagator(
            adj, x.shape[1], backend="segment", precision="bf16_carry",
            device=DEV))
    build_s = time.time() - t0
    padded = prop.adj_op
    n, nfeat = x.shape
    e_pad, nnz = padded.num_edges_padded, ops["f32"].adj_op.nnz
    scale = 1.0 - cfg.alpha
    x0 = x.bfloat16() * bf16_round(cfg.alpha)
    differ, ulps, worst = _bf16_hops(padded, x0, scale, cfg.order)
    print(f"[3g] coo_spmm bf16 carries: {cfg.order} fused ppr hops at "
          f"[{n},{nfeat}] one at a time on a shared input: elements "
          f"differing {differ} (limit 0: bit for bit, every row), largest "
          f"difference {ulps} bf16 ulps, max_abs_err {worst}", flush=True)
    if differ:
        raise AssertionError(f"coo_spmm's bf16 form disagrees with its "
                             f"plain version: {differ} elements, {ulps} "
                             f"ulps")
    ref = ops["f32"](x, **kw)
    _reset_counts()
    out, gb = _peak_gb(lambda: prop(x, precision=precision, **kw))
    launches = _read_counts()
    err = _errors(out.float(), ref)
    print(f"[3g] exact_propagator(backend='segment', "
          f"precision='bf16_carry') {cfg.order} ppr hops: launches "
          f"{launches}; out {out.dtype}; against the csr backend's f32 run "
          f"max_abs_err {err[0]} max_rel_err {err[1]} (gate 2e-2); peak "
          f"device memory above the resident operands {gb} GB (f32 segment "
          f"{seg['peak_extra_GB']['segment']} GB); build {build_s} s "
          f"({build_gb} GB)", flush=True)
    bad = {k: v for k, v in launches.items()
           if v != (cfg.order if k == "coo_spmm" else 0)}
    if bad or out.dtype != torch.bfloat16 or not err[1] <= 2e-2:
        raise AssertionError(f"segment bf16_carry path: launches {bad}, "
                             f"dtype {out.dtype}, err {err}")
    del out, ref
    y, acc = torch.empty_like(x0), x0.clone()
    ms = _time_ms(lambda: spmm_segment_prop_step(padded, x0, y, acc, scale,
                                                 True), 30)
    device_ms = _device_ms(lambda: spmm_segment_prop_step(
        padded, x0, y, acc, scale, True), 30, "coo_spmm_kernel")
    plain_ms = _time_ms(lambda: spmm_segment_prop_step_plain(
        padded, x0, y, acc, scale, True), 3, warmup=1)
    run_ms = _time_ms(lambda: prop(x, precision=precision, **kw), 10)
    csr_ms = _time_ms(lambda: ops["bf16"](x, precision="bf16", **kw), 10)
    # the library call: torch.sparse.mm on a bf16 CSR of the same operator
    # (this torch's sparse.mm refuses a bf16 COO, noted beside it)
    op = ops["f32"].adj_op
    a = torch.sparse_csr_tensor(op.indptr, op.indices, op.values.bfloat16(),
                                size=(op.num_rows, n))
    library_ms = _time_ms(lambda: torch.sparse.mm(a, x0), 30)
    library = "torch.sparse.mm on the bf16 CSR"
    try:
        coo = torch.sparse_coo_tensor(
            torch.stack([padded.rows.long(), padded.cols.long()]),
            padded.vals.bfloat16(), (n + 1, n)).coalesce()
        coo_ms = _time_ms(lambda: torch.sparse.mm(coo, x0), 30)
        library += f"; on the coalesced bf16 COO {coo_ms} ms"
        del coo
    except RuntimeError as e:
        library += (f"; on the coalesced bf16 COO it raises: "
                    f"{str(e).splitlines()[0][:120]}")
    del a, y, acc
    # each padded edge's 12 bytes, x read, acc read, y and acc written, at
    # 2 bytes an element; the gathers read nnz rows of x
    nbytes = 12 * e_pad + 8 * n * nfeat
    bound_ms, bound_by = _bound(nbytes, 2 * nnz * nfeat + 2 * n * nfeat)
    gather_bytes = nbytes + 2 * nfeat * nnz
    gather_bound = gather_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[3g] coo_spmm bf16 fused hop at [{n},{nfeat}]: ms {ms} "
          f"(device_ms {device_ms}; f32 form {seg['ms']}) plain_ms "
          f"{plain_ms} bound_ms {bound_ms} ({bound_by}, "
          f"{nbytes / 1e9:.3f} GB, {bound_ms / ms:.1%} of it; with its "
          f"gathers {gather_bound} ms, {gather_bytes / 1e9:.3f} GB) "
          f"library_ms {library_ms} ({library}, A x only); the whole "
          f"{cfg.order}-hop run ms {run_ms}, against the f32 segment run's "
          f"{seg['run_ms']} and the csr bf16_carry run's {csr_ms}",
          flush=True)
    return {"name": "coo_spmm_bf16_carry", "route": "cuda",
            "source": "grandtpu_torch/csrc/coo_spmm.cu",
            "replaces": "grandtpu/sparse/spmm.py:74",
            "max_abs_err": worst, "max_bf16_ulps": ulps,
            "elements_differing": differ,
            "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "gather_bound_ms": gather_bound, "library_ms": library_ms,
            "library": library,
            "shape": f"x [{n},{nfeat}] bf16, {e_pad} padded edges, per "
                     "fused hop (spmm_segment_prop_step on bf16 carries)",
            "run_ms": run_ms, "csr_bf16_carry_run_ms": csr_ms,
            "f32_segment_run_ms": seg["run_ms"],
            "launches_by_path": {"segment_bf16_carry": launches["coo_spmm"]},
            "peak_extra_GB": {"segment_bf16_carry": gb,
                              "segment_f32": seg["peak_extra_GB"]["segment"]},
            "propagate_vs_f32_max_rel_err": err[1]}


# phase 8's runs: (name, halo_threshold, precision, the kernels of its
# hops, each launched order x SHARDS times, but those of D1_FIRST_HOP once
# a shard: the all_gather int8 hops after the first quantize on the maxima
# the hop before raised)
D1_FIRST_HOP = {"all_gather_int8": {"column_absmax"}}
D1_RUNS = (
    ("all_gather_f32", None, "f32", {"csr_spmm_prop"}),
    ("all_gather_bf16", None, "bf16", {"csr_spmm_prop_bf16"}),
    ("all_gather_int8", None, "int8",
     {"column_absmax", "quantize_with_amax", "csr_spmm_q8mxu"}),
    ("halo_f32", 1.0, "f32", {"halo_pack", "halo_hop"}),
    ("halo_int8", 1.0, "int8", {"column_absmax", "halo_pack", "halo_hop"}),
    ("scatter_f32", None, "f32", {"coo_spmm"}),
)


def _d1_times(prop, xs, tag: str) -> dict:
    """The halo kernels (f32 and int8 forms), the quantize split and the
    collectives at shard 0's shapes of ``prop`` (a HaloPropagator)."""
    mesh, g = prop.mesh, prop.g
    S, c_max, nfeat = g.num_shards, g.halo_per_pair, xs[0].shape[1]
    rows = g.rows_per_shard
    x0, idx0, plan0 = xs[0], prop.send_idx[0], prop.plans[0]
    m = idx0.numel()
    uniq = torch.unique(idx0).numel()
    amax = mesh.pmax([column_absmax(x) for x in xs])
    out = {}
    # halo_pack, f32 and int8: the distinct gathered rows read once, the
    # index, the send buffer written
    for form, a in (("f32", None), ("int8", amax[0])):
        width = 4 if a is None else 1
        nbytes = uniq * nfeat * 4 + 4 * m + m * nfeat * width + (
            0 if a is None else 8 * nfeat)
        ms = _time_ms(lambda: halo_pack(x0, idx0, a, plan0), 30)
        dev = _device_ms(lambda: halo_pack(x0, idx0, a, plan0), 30,
                         "halo_pack_kernel")
        plain_ms = _time_ms(lambda: halo_pack_plain(x0, idx0, a), 3)
        if a is None:
            lib = _time_ms(lambda: torch.index_select(x0, 0, idx0), 30)
        else:
            lib = _time_ms(lambda: quantize_with_amax_plain(
                torch.index_select(x0, 0, idx0), a), 10)
        b = _bound(nbytes, m * nfeat * (0 if a is None else 3))
        out[f"halo_pack_{form}"] = {"ms": ms, "device_ms": dev,
                                    "plain_ms": plain_ms,
                                    "library_ms": lib, "bound_ms": b[0],
                                    "bound_by": b[1]}
    # halo_hop, f32 and the exact int8 form, on a real exchange
    for form, a in (("f32", None), ("exact", amax)):
        packs = [halo_pack(x, i, aa, pl) for x, i, aa, pl in
                 zip(xs, prop.send_idx, a or [None] * S, prop.plans)]
        recv = mesh.all_to_all([p.view(S, c_max, -1) for p, _ in packs])
        r0 = recv[0].view(S * c_max, -1)
        sc = packs[0][1]
        rv = prop.row_val[0] if form == "exact" else None
        y, acc = torch.empty_like(x0), torch.zeros_like(x0)
        diag, halo = prop.diag[0], prop.halo[0]

        def hop(fn):
            fn(diag, halo, x0, r0, y, acc, 0.8, True, sc, rv)

        ms = _time_ms(lambda: hop(halo_hop), 30)
        plain_ms = _time_ms(lambda: hop(halo_hop_plain), 3, warmup=1)
        width = 4 if form == "f32" else 1
        nbytes = (8 * (rows + 1) + 8 * diag.nnz + 4 * halo.nnz
                  + (4 * halo.nnz if form == "f32" else 4 * rows + 4 * nfeat)
                  + rows * nfeat * 4 + S * c_max * nfeat * width
                  + 3 * rows * nfeat * 4)
        b = _bound(nbytes, 2 * (diag.nnz + halo.nnz) * nfeat
                   + 3 * rows * nfeat)
        out[f"halo_hop_{form}"] = {"ms": ms, "plain_ms": plain_ms,
                                   "library_ms": None, "bound_ms": b[0],
                                   "bound_by": b[1]}
        del packs, recv, r0, y, acc
    # the quantize split at a shard's block
    ms = _time_ms(lambda: column_absmax(x0), 30)
    plain_ms = _time_ms(lambda: column_absmax_plain(x0), 10)
    lib = _time_ms(lambda: torch.linalg.vector_norm(x0, float("inf"), 0), 30)
    b = _bound(rows * nfeat * 4 + 4 * nfeat, rows * nfeat)
    out["column_absmax"] = {"ms": ms, "plain_ms": plain_ms,
                            "library_ms": lib, "bound_ms": b[0],
                            "bound_by": b[1]}
    ms = _time_ms(lambda: quantize_with_amax(x0, amax[0]), 30)
    plain_ms = _time_ms(lambda: quantize_with_amax_plain(x0, amax[0]), 10)
    b = _bound(rows * nfeat * 5 + 8 * nfeat, 3 * rows * nfeat)
    out["quantize_with_amax"] = {"ms": ms, "plain_ms": plain_ms,
                                 "library_ms": None, "bound_ms": b[0],
                                 "bound_by": b[1]}
    # the collectives: copies on the one card
    sends = [halo_pack(x, i, None, pl)[0].view(S, c_max, -1)
             for x, i, pl in zip(xs, prop.send_idx, prop.plans)]
    out["all_gather_ms"] = _time_ms(lambda: mesh.all_gather(xs), 10)
    out["all_to_all_ms"] = _time_ms(lambda: mesh.all_to_all(sends), 10)
    out["pmax_ms"] = _time_ms(lambda: mesh.pmax(amax), 10)
    for k, v in out.items():
        print(f"[{tag}] {k} at shard 0 ([{rows},{nfeat}], {m} send rows): "
              f"{v}", flush=True)
    return out


def _d1_bound(prop, precision: str, nfeat: int, order: int) -> float:
    """Least time of one D1 run of ``order`` hops: every kernel launch's
    least bytes (its inputs read once, its outputs written once: each
    shard's operator, the whole gathered or received input, the shard's
    carries) plus the collectives' copies (read and written once on the
    one card), over the card's memory rate. Their operations are far
    below the f32 peak's time."""
    g, S = prop.g, prop.mesh.size
    rows, n_pad = g.rows_per_shard, g.rows_per_shard * S
    carries = 3 * rows * nfeat * 4           # y written, acc read + written
    width = 1 if precision == "int8" else 4
    quantize = (rows * nfeat * 4 + rows * nfeat * 5 + 12 * nfeat
                if precision == "int8" else 0)   # column max, quantize
    nbytes = 0
    if isinstance(prop, ShardedPropagator):
        for s in range(S):
            edges = int(np.count_nonzero(g.vals[s]))
            nbytes += 12 * edges + n_pad * nfeat * 4 + 4 * rows + carries
        nbytes += 2 * n_pad * nfeat * 4                  # the all_gather
    elif hasattr(prop, "send_idx"):                      # the halo exchange
        c_max = g.halo_per_pair
        for s in range(S):
            idx = prop.send_idx[s]
            m, uniq = idx.numel(), torch.unique(idx).numel()
            diag, halo = prop.diag[s], prop.halo[s]
            pack = uniq * nfeat * 4 + 4 * m + m * nfeat * width
            hop = (8 * (rows + 1) + 8 * diag.nnz + 4 * halo.nnz
                   + (4 * halo.nnz if width == 4 else 4 * rows + 4 * nfeat)
                   + rows * nfeat * 4 + S * c_max * nfeat * width + carries)
            nbytes += pack + hop + quantize
        nbytes += 2 * S * S * c_max * nfeat * width      # the all_to_all
    else:                                                # all_gather
        # int8: the column max reads the shards once, at the first hop;
        # the later hops quantize on the maxima their hops raised
        first = 0
        if precision == "int8":
            quantize = rows * nfeat * 5 + 12 * nfeat
            first = S * rows * nfeat * 4
        for s, op in enumerate(prop.ops):
            graph = (4 * op.nnz + 8 * rows if precision == "int8"
                     and prop.row_val is not None else 8 * op.nnz)
            nbytes += (graph + 4 * (rows + 1) + n_pad * nfeat * width
                       + carries + quantize)
        nbytes += 2 * n_pad * nfeat * width              # the all_gather
        return (order * nbytes + first) / HBM_BYTES_PER_S * 1e3
    return order * nbytes / HBM_BYTES_PER_S * 1e3

def check_d1(ops: dict) -> dict:
    """Phase 8: D1 on a 4-shard mesh on the one card. Returns the launches
    of each run, the errors and the times."""
    cfg = preset("Amazon2M")
    adj, x, single = ops["adj"], ops["x"], ops["f32"]
    kw = dict(mode="ppr", order=cfg.order, alpha=cfg.alpha)
    mesh = make_mesh(SHARDS, devices=[DEV] * SHARDS)
    ref = {p: single(x, precision=p, **kw) for p in ("f32", "bf16", "int8")}
    res = {"launches": {}, "err": {}, "wall_s": {}}
    halo_prop = None
    for name, threshold, precision, kernels in D1_RUNS:
        t0 = time.time()
        if name.startswith("scatter"):
            prop = ShardedPropagator(mesh, ShardedGraph.build(adj, SHARDS))
            call = {}
        else:
            prop, p = dist_exact_propagator(mesh, adj, x.shape[1],
                                            halo_threshold=threshold,
                                            precision=precision)
            call = {"precision": p}
        torch.cuda.synchronize(DEV)
        build_s = time.time() - t0
        _reset_counts()
        t0 = time.time()
        out = prop(x, **kw, **call)
        torch.cuda.synchronize(DEV)
        hops_s = time.time() - t0
        launches = _read_counts()
        plain = prop(x, **kw, **call, plain=True)
        e_plain = _errors(out, plain)
        bound_ms = _d1_bound(prop, precision, x.shape[1], cfg.order)
        e_single = _errors(out, ref[precision])
        e_f32 = _errors(out, ref["f32"])
        limit = 5e-3 if precision == "int8" else TOL
        first = D1_FIRST_HOP.get(name, set())
        want = {k: (SHARDS if k in first else cfg.order * SHARDS)
                if k in kernels else 0 for k in launches}
        # the one-card run's own distance from f32, which the sharded run
        # of the same form must not exceed by more than 1e-3
        own = _errors(ref[precision], ref["f32"])[1]
        gate = TOL if precision == "f32" else 5e-3
        print(f"[8] {name} ({type(prop).__name__}, {SHARDS} shards of "
              f"{prop.g.rows_per_shard} rows): build {build_s} s, "
              f"{cfg.order} hops {hops_s} s (bound {bound_ms} ms); launches "
              f"{ {k: v for k, v in launches.items() if v} }; vs its plain "
              f"run max_rel_err {e_plain[1]} (limit {limit}); vs the "
              f"one-card Propagator at {precision} {e_single[1]}; vs f32 "
              f"{e_f32[1]} (the one-card {precision} run: "
              f"{own}; fast-path gate {gate}: "
              f"{'held' if e_f32[1] <= gate else 'exceeded'})", flush=True)
        if launches != want:
            raise AssertionError(f"[8] {name}: launches {launches}, want "
                                 f"{want}")
        # the fast forms against f32 only: the halo's quantizes the
        # exchanged rows alone, so it need not be near the one-card int8
        if not (e_plain[1] <= limit and e_f32[1] <= max(gate, own + 1e-3)):
            raise AssertionError(f"[8] {name}: {e_plain[1]} from its plain "
                                 f"run, {e_single[1]} from the one-card run, "
                                 f"{e_f32[1]} from f32 (one-card {own})")
        res["launches"][name] = launches
        res["err"][name] = {"vs_plain": e_plain, "vs_single": e_single[1],
                            "vs_f32": e_f32[1]}
        res["wall_s"][name] = {"build": build_s, "hops": hops_s,
                               "bound_ms": bound_ms}
        if name == "halo_f32":
            halo_prop = prop
        del out, plain
    print(f"[8] halo compression {halo_prop.g.compression} (C_max "
          f"{halo_prop.g.halo_per_pair} of {halo_prop.g.rows_per_shard} "
          f"rows a shard)", flush=True)
    xs = [b.contiguous() for b in
          torch.cat([x, x.new_zeros(halo_prop.g.rows_per_shard * SHARDS
                                    - x.shape[0], x.shape[1])]).split(
              halo_prop.g.rows_per_shard)]
    res["times"] = _d1_times(halo_prop, xs, "8")
    res["compression"] = halo_prop.g.compression
    res["shape"] = (f"shard [{halo_prop.g.rows_per_shard},{x.shape[1]}], "
                    f"{halo_prop.g.halo_per_pair} rows a pair")
    return res


# 8m's runs on the TP_SHAPE mesh of the card: (name, axis, halo_threshold,
# precision, the kernels of its hops), launched as phase 8's on every
# shard of the mesh
D1_2D_RUNS = (
    ("all_gather_f32", "data", None, "f32", {"csr_spmm_prop"}),
    ("all_gather_int8", "data", None, "int8",
     {"column_absmax", "quantize_with_amax", "csr_spmm_q8mxu"}),
    ("halo_int8", "data", 1.0, "int8",
     {"column_absmax", "halo_pack", "halo_hop"}),
    ("scatter_f32", "data", None, "f32", {"coo_spmm"}),
    ("all_gather_f32", "model", None, "f32", {"csr_spmm_prop"}),
    ("halo_f32", "model", 1.0, "f32", {"halo_pack", "halo_hop"}),
)


def check_d1_2d(ops: dict, d1: dict) -> dict:
    """Phase 8m: D1 on the (2 x 2) mesh of the card (TP_SHAPE), sharded
    along 'data' (the model columns replicas) and along 'model' (the data
    rows replicas), each run a path of its own: exact launch counts on
    every shard, every group's result equal, held to its plain run at
    phase 8's limits and bit for bit to the same form on a 1-D mesh of
    the axis's 2 shards of the card. Returns the launches, errors and
    times."""
    cfg = preset("Amazon2M")
    adj, x = ops["adj"], ops["x"]
    kw = dict(mode="ppr", order=cfg.order, alpha=cfg.alpha)
    n_data, n_model = TP_SHAPE
    mesh = make_mesh(n_data, n_model=n_model,
                     devices=[DEV] * (n_data * n_model))
    res = {"launches": {}, "err": {}, "wall_s": {}, "held_GB": {}}
    for name, axis, threshold, precision, kernels in D1_2D_RUNS:
        run = f"{name}_{axis}"
        shards = mesh.shape[axis]
        torch.cuda.synchronize(DEV)
        before = torch.cuda.memory_allocated(DEV)
        t0 = time.time()
        if name.startswith("scatter"):
            prop = ShardedPropagator(mesh, ShardedGraph.build(adj, shards),
                                     axis)
            call = {}
        else:
            prop, p = dist_exact_propagator(mesh, adj, x.shape[1],
                                            axis=axis,
                                            halo_threshold=threshold,
                                            precision=precision)
            call = {"precision": p}
        torch.cuda.synchronize(DEV)
        build_s = time.time() - t0
        held = (torch.cuda.memory_allocated(DEV) - before) / 1e9
        _reset_counts()
        t0 = time.time()
        outs = prop.each(x, **kw, **call)
        torch.cuda.synchronize(DEV)
        hops_s = time.time() - t0
        launches = _read_counts()
        groups_equal = all(torch.equal(o, outs[0]) for o in outs[1:])
        e_plain = _errors(outs[0], prop(x, **kw, **call, plain=True))
        one = type(prop)(_mesh(shards), prop.g)
        same_1d = bool(torch.equal(outs[0], one(x, **kw, **call)))
        del one
        bound_ms = sum(_d1_bound(q, precision, x.shape[1], cfg.order)
                       for q in prop.groups)
        limit = 5e-3 if precision == "int8" else TOL
        first = D1_FIRST_HOP.get(name, set())
        want = {k: (mesh.size if k in first else cfg.order * mesh.size)
                if k in kernels else 0 for k in launches}
        flat = d1["wall_s"][name]
        print(f"[8m] {name} along '{axis}' ({type(prop).__name__}, "
              f"{len(prop.groups)} groups of {shards} shards of "
              f"{prop.g.rows_per_shard} rows on a {n_data} x {n_model} "
              f"mesh of the card): build {build_s} s, {cfg.order} hops "
              f"{hops_s} s (bound {bound_ms} ms; phase 8 on 4 shards: build "
              f"{flat['build']} s, hops {flat['hops']} s, bound "
              f"{flat['bound_ms']} ms); operators held {held} GB; launches "
              f"{ {k: v for k, v in launches.items() if v} }; groups equal "
              f"{groups_equal}; vs its plain run max_rel_err {e_plain[1]} "
              f"(limit {limit}); bit for bit the 1-D mesh of {shards} "
              f"shards: {same_1d}", flush=True)
        if launches != want:
            raise AssertionError(f"[8m] {run}: launches {launches}, want "
                                 f"{want}")
        if not (groups_equal and same_1d and e_plain[1] <= limit
                and outs[0].shape == x.shape):
            raise AssertionError(f"[8m] {run}: groups equal {groups_equal},"
                                 f" 1-D equal {same_1d}, {e_plain[1]} from "
                                 f"its plain run")
        res["launches"][run] = launches
        res["err"][run] = {"vs_plain": e_plain, "groups_equal": groups_equal,
                           "equal_1d": same_1d}
        res["wall_s"][run] = {"build": build_s, "hops": hops_s,
                              "bound_ms": bound_ms}
        res["held_GB"][run] = held
        del prop, outs
    return res


def run_serving(r, data, ckpt: str) -> dict:
    """Phase 5e: the predict CLI from 5d's best.npz, at f32 and auto, each
    a path of its own; its test accuracy against 5d's model at the same
    precision. Returns the launches by precision."""
    cfg = preset("Amazon2M").replace(dataset=AMAZON)
    adj_sl = add_self_loops_adj(data.adj)
    feats = torch.as_tensor(data.features, device=DEV)
    want = {"auto": r.test_acc,
            "f32": test_accuracy(r.model, exact_propagate(
                adj_sl, feats, mode=cfg.prop_mode, order=cfg.order,
                alpha=cfg.alpha, device=DEV), data.idx_test,
                data.labels_int)}
    del feats
    torch.cuda.empty_cache()
    # the same checkpoint as a directory (ckpt_backend "orbax")
    as_dir = ckpt[: -len(".npz")] + "_dir"
    template = model_trees(r.model)
    params, state, _, meta = load_checkpoint(
        ckpt, params_template=template[0], state_template=template[1])
    save_checkpoint(as_dir, params=params, state=state, backend="orbax",
                    **{k: meta[k] for k in ("num_batch", "best_val_acc",
                                            "best_val_loss")},
                    row_padded=meta["__row_padded__"])
    with np.load(ckpt) as z:
        flat, dir_flat = {k: z[k] for k in z.files}, _load_directory(as_dir)
        if not (sorted(flat) == sorted(dir_flat) and all(
                np.array_equal(flat[k], dir_flat[k]) for k in flat)):
            raise AssertionError(f"[5e] {as_dir} is not {ckpt}")
    res = {}
    for tag, precision, form, path in (
            ("f32", "f32", "f32", ckpt), ("auto", "auto", "int8mxu", ckpt),
            ("f32_dir", "f32", "f32", as_dir)):
        out_npz = os.path.join(CKPT_DIR, f"predictions_{tag}.npz")
        argv = ["predict", "--preset", "Amazon2M", "--dataset", AMAZON,
                "--ckpt", path, "--precision", precision, "--output",
                out_npz]
        stdout, stderr = io.StringIO(), io.StringIO()
        _reset_counts()
        t0 = time.time()
        with contextlib.redirect_stdout(stdout), \
                contextlib.redirect_stderr(stderr):
            rc = cli(argv)
        wall = time.time() - t0
        launches = _read_counts()
        if rc != 0:
            raise AssertionError(f"[5e] predict {precision} exited {rc}: "
                                 f"{stderr.getvalue()[-2000:]}")
        line = json.loads(stdout.getvalue().strip().splitlines()[-1])
        seconds = json.loads(stderr.getvalue().strip().splitlines()[-1])
        with np.load(out_npz) as z:
            shape = z["logits"].shape
            finite = bool(np.isfinite(z["logits"]).all())
        print(f"[5e] python -m grandtpu_torch.cli.main {' '.join(argv)}: "
              f"{line}; wall {wall} s, {seconds['predict_seconds']}; logits "
              f"{shape}, finite {finite}; launches "
              f"{ {k: v for k, v in launches.items() if v} }; test_acc "
              f"{line['test_acc']} against train()'s model at {precision} "
              f"{want[precision]}", flush=True)
        if not (shape == (data.num_nodes, data.num_classes) and finite
                and line["test_acc"] == want[precision]):
            raise AssertionError(f"[5e] predict {precision}: logits {shape}, "
                                 f"finite {finite}, test_acc "
                                 f"{line['test_acc']} != {want[precision]}")
        _check_hops(launches, form, cfg.order)
        res[tag] = {"launches": launches, "wall_s": wall,
                    **seconds["predict_seconds"]}
    with np.load(os.path.join(CKPT_DIR, "predictions_f32.npz")) as a, \
            np.load(os.path.join(CKPT_DIR, "predictions_f32_dir.npz")) as b:
        same = np.array_equal(a["logits"], b["logits"])
    print(f"[5e] predict from {as_dir} (the same checkpoint as a "
          f"directory): logits bit for bit the npz's {same}; checkpoint_s "
          f"{res['f32_dir']['checkpoint_s']} (npz "
          f"{res['f32']['checkpoint_s']})", flush=True)
    if not same:
        raise AssertionError("[5e] the directory's logits differ")
    return res


# The predict CLI in a child process, with the launch counts of the
# counted wrappers (COUNTED, imported from this script) and whether each K2-q8mxu hop ran on a split plan, on stderr
# after the CLI's own line.
_PREDICT_CHILD = """
import json, sys
import grandtpu_torch.infer.propagate as propagate
from chip_smoke import COUNTED
from grandtpu_torch.cli.main import cli
split = []
real = propagate.spmm_prop_step_q8mxu
def spy(op, *args, **kwargs):
    split.append(op.plan is not None)
    return real(op, *args, **kwargs)
propagate.spmm_prop_step_q8mxu = spy
rc = cli(sys.argv[1:])
print(json.dumps({"launches": {k: f.launches for k, f in COUNTED.items()},
                  "q8mxu_split": split}), file=sys.stderr)
sys.exit(rc)
"""


def write_amazon2m_files(data, path: str) -> tuple:
    """5d's graph with FILE_HUBS hub rows (self-loops dropped, as the
    Amazon2M adjacency has none) in the Amazon2M file layout
    (grandtpu/data/registry.py:149-159): the adjacency npz uncompressed,
    the features, the labels as class ids. Returns the adjacency and the
    seconds of the hubs and of the writes."""
    t0 = time.time()
    adj = eliminate_self_loops_adj(add_hub_rows(data.adj, *FILE_HUBS))
    hub_s = time.time() - t0
    t0 = time.time()
    sp.save_npz(os.path.join(path, "Amazon2M_adj.npz"), adj,
                compressed=False)
    np.save(os.path.join(path, "Amazon2M_feat.npy"),
            np.asarray(data.features, np.float32))
    np.save(os.path.join(path, "Amazon2M_labels.npy"), data.labels_int)
    return adj, hub_s, time.time() - t0


def _files_propagation(adj, x, cfg) -> dict:
    """5f's propagation on the card: the int8 run's error against f32; one
    split K2-q8mxu hop on the loaded graph's operator bit for bit its plain
    version and the unsplit hop; the split hop's time against the unsplit
    one's."""
    prop = Propagator(add_self_loops_adj(adj), backend="csr", device=DEV)
    op, row_val = prop.adj_op, prop.row_val
    if op.plan is None or row_val is None:
        raise AssertionError("[5f] the operator has no split plan or its rows "
                             "are not constant")
    kw = dict(mode="ppr", order=cfg.order, alpha=cfg.alpha)
    ref = prop(x, **kw)
    err = _errors(prop(x, precision="int8", **kw), ref)[1]
    del ref
    max_deg = int((op.indptr[1:] - op.indptr[:-1]).max())
    whole = CSROperator(op.indptr, op.indices, op.values, op.num_rows,
                        split_cap=max_deg)
    x0 = cfg.alpha * x
    q, q_scale = quantize_columns(x0)
    scale = 1.0 - cfg.alpha
    # one split hop at the path's shape bit for bit its plain version
    # (which follows the same plan) and the unsplit hop (int32 sums)
    acc0 = x0.flip(0).contiguous()
    hops = {}
    for tag, o, fn in (("split", op, spmm_prop_step_q8mxu),
                       ("plain", op, spmm_prop_step_q8mxu_plain),
                       ("unsplit", whole, spmm_prop_step_q8mxu)):
        y, acc = torch.empty_like(x0), acc0.clone()
        fn(o, q, q_scale, row_val, y, acc, scale, True)
        hops[tag] = (y, acc)
    torch.cuda.synchronize(DEV)
    differ = {tag: sum(int((a != b).sum())
                       for a, b in zip(hops["split"], hops[tag]))
              for tag in ("plain", "unsplit")}
    print(f"[5f] K2-q8mxu split hop at the path's shape: elements differing "
          f"from its plain version {differ['plain']}, from the unsplit hop "
          f"{differ['unsplit']} (limit 0 each: bit for bit)", flush=True)
    if differ["plain"] or differ["unsplit"]:
        raise AssertionError(f"[5f] the split K2-q8mxu hop is not bit for "
                             f"bit: {differ} elements differ")
    del hops, acc0
    y, acc = torch.empty_like(x0), torch.zeros_like(x0)
    hop = {tag: (lambda o=o: spmm_prop_step_q8mxu(
               o, q, q_scale, row_val, y, acc, scale, True))
           for tag, o in (("split", op), ("unsplit", whole))}
    ms = {tag: _time_ms(fn, 30) for tag, fn in hop.items()}
    n, nfeat = x0.shape
    # q read, f32 y written, acc read and written, the structure, row_val
    nbytes = n * nfeat * 13 + nfeat * 4 + 4 * (n + 1) + 4 * op.nnz + 4 * n
    bound_ms, bound_by = _bound(nbytes, op.nnz * nfeat + 4 * n * nfeat)
    split = {"ms": ms["split"], "bound_ms": bound_ms, "bound_by": bound_by,
             **_int8_times(hop["split"], op, q, q_scale, y, acc, nbytes)}
    out = {"int8_rel_err_vs_f32": err, "nnz": op.nnz, "longest_row": max_deg,
           "cap": op.plan.cap, "split_rows": int(op.plan.rows.numel()),
           "chunks": op.plan.num_chunks, "q8mxu_split_ms": ms["split"],
           "q8mxu_unsplit_ms": ms["unsplit"], "q8mxu_split": split,
           "elements_differing": differ}
    print(f"[5f] the loaded graph's operator: nnz {op.nnz}, longest row "
          f"{max_deg}, cap {op.plan.cap}: {out['split_rows']} split rows, "
          f"{out['chunks']} chunks; {cfg.order}-hop ppr at int8 against f32 "
          f"max_rel_err {err} (fast-path gate 5e-3, reported: "
          f"{'within' if err <= 5e-3 else 'over'}); K2-q8mxu hop split "
          f"{ms['split']} ms, unsplit {ms['unsplit']} ms (predicted "
          f"1.2-1.45 ms split); split bound_ms {bound_ms} ({bound_by}, "
          f"{nbytes / 1e9:.3f} GB), {_int8_line(split)}", flush=True)
    return out


def run_serving_files(data) -> dict:
    """Phase 5f: the slice's path, serving a power-law graph from its files.
    5d's graph plus hub rows is written in the Amazon2M layout to a
    temporary directory (removed at the end), ``train()`` with the
    Amazon2M preset (full width, 1 epoch, ``auto``) loads it through
    $GRANDTPU_DATA_DIR and writes best.npz, then the predict CLI runs from
    it at f32, int8 and auto, each in a child process, each a path."""
    cfg = preset("Amazon2M").replace(dataset="Amazon2M", epochs=1,
                                     predict_precision="auto")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_5f_")
    old_dir = os.environ.get("GRANDTPU_DATA_DIR")
    try:
        adj, hub_s, write_s = write_amazon2m_files(data, tmp)
        os.environ["GRANDTPU_DATA_DIR"] = tmp
        print(f"[5f] {data.name} with {FILE_HUBS[0]} hub rows x "
              f"{FILE_HUBS[1]} random neighbours: nnz {adj.nnz} (no "
              f"self-loops), hubs added in {hub_s:.3f} s, the Amazon2M files "
              f"written to a temporary directory in {write_s:.3f} s",
              flush=True)
        ckpt_dir = os.path.join(tmp, "ckpt")
        # the train path's K2-q8mxu hops, each on a split plan or not
        real, split = propagate_mod.spmm_prop_step_q8mxu, []
        propagate_mod.spmm_prop_step_q8mxu = (
            lambda op, *a, **k: (split.append(op.plan is not None),
                                 real(op, *a, **k))[1])
        try:
            r, train_launches = run_path(cfg.replace(ckpt_dir=ckpt_dir), None,
                                         "5f-train")
        finally:
            propagate_mod.spmm_prop_step_q8mxu = real
        if r.predict_precision != "int8mxu" or not split or not all(split):
            raise AssertionError(f"[5f] train() ran {r.predict_precision}, "
                                 f"K2-q8mxu hops on a split plan: {split}")
        if train_launches["dropnode_mean"] < r.num_batches + len(r.history):
            raise AssertionError("[5f] K1 was not launched for every step "
                                 "and eval")
        res = {"train": {"launches": train_launches,
                         "total_s": r.total_time, "test_acc": r.test_acc}}
        out_npz = os.path.join(tmp, "predictions.npz")
        here = os.path.dirname(os.path.abspath(__file__))
        torch.cuda.empty_cache()      # the children allocate on the card
        for precision, form in (("f32", "f32"), ("int8", "int8mxu"),
                                ("auto", "int8mxu")):
            argv = ["predict", "--preset", "Amazon2M", "--ckpt",
                    os.path.join(ckpt_dir, "best.npz"), "--precision",
                    precision, "--output", out_npz]
            t0 = time.time()
            child = subprocess.run(
                [sys.executable, "-c", _PREDICT_CHILD, *argv], cwd=here,
                capture_output=True, text=True, timeout=600)
            wall = time.time() - t0
            if child.returncode != 0:
                raise AssertionError(f"[5f] predict {precision} exited "
                                     f"{child.returncode}: "
                                     f"{child.stderr[-3000:]}")
            line = json.loads(child.stdout.strip().splitlines()[-1])
            err_lines = child.stderr.strip().splitlines()
            seconds = json.loads(err_lines[-2])["predict_seconds"]
            counts = json.loads(err_lines[-1])
            launches = counts["launches"]
            print(f"[5f] python -m grandtpu_torch.cli.main {' '.join(argv)} "
                  f"(a child process): {line}; wall {wall} s, {seconds}; "
                  f"launches { {k: v for k, v in launches.items() if v} }, "
                  f"K2-q8mxu hops on a split plan {counts['q8mxu_split']}; "
                  f"data_s {seconds['data_s']} from the files against 11.25 "
                  f"s of generating synth:2000000:47:100 (H100 80GB HBM3, "
                  f"700 W)", flush=True)
            _check_hops(launches, form, cfg.order)
            if form == "int8mxu" and not (counts["q8mxu_split"]
                                          and all(counts["q8mxu_split"])):
                raise AssertionError(f"[5f] predict {precision}: K2-q8mxu "
                                     "ran without the split plan")
            res[precision] = {"launches": launches, "wall_s": wall,
                              "test_acc": line["test_acc"], **seconds}
        for precision in ("int8", "auto"):
            gap = abs(res[precision]["test_acc"] - res["f32"]["test_acc"])
            print(f"[5f] test_acc {precision} {res[precision]['test_acc']} "
                  f"against f32 {res['f32']['test_acc']}: |d| {gap} (limit "
                  f"2e-3); train()'s own (auto) {r.test_acc}", flush=True)
            if gap > 2e-3:
                raise AssertionError(f"[5f] {precision} test_acc is {gap} "
                                     "from f32's")
        if res["auto"]["test_acc"] != r.test_acc:
            raise AssertionError(f"[5f] predict auto test_acc "
                                 f"{res['auto']['test_acc']} != train()'s "
                                 f"{r.test_acc}")
        res["propagation"] = _files_propagation(
            adj, torch.as_tensor(data.features, device=DEV), cfg)
        return res
    finally:
        if old_dir is None:
            os.environ.pop("GRANDTPU_DATA_DIR", None)
        else:
            os.environ["GRANDTPU_DATA_DIR"] = old_dir
        shutil.rmtree(tmp, ignore_errors=True)


def serving_entries(seg: dict, d1: dict, serve: dict) -> list:
    """The kernels line's entries of K2-seg, the column maxima and D1's
    kernels, launches by path (``quantize_with_amax``, now on every int8
    path, is 3d's entry, with the shard shape's time as ``shard``)."""
    runs = d1["launches"]
    times = d1["times"]
    seg["launches_by_path"]["d1_scatter"] = runs["scatter_f32"]["coo_spmm"]
    seg["launches"] = sum(seg["launches_by_path"].values())
    entries = [seg]
    rows = (("column_absmax", "grandtpu/dist/spmm_shard.py:341",
             times["column_absmax"]),
            ("halo_pack", "grandtpu/dist/halo.py:311",
             times["halo_pack_int8"] | {"f32_form": times["halo_pack_f32"]}),
            ("halo_hop", "grandtpu/dist/halo.py:325",
             times["halo_hop_exact"] | {"f32_form": times["halo_hop_f32"]}))
    for name, line, t in rows:
        by_path = {p: la[name] for p, la in runs.items() if la[name]}
        err = max([d1["err"][p]["vs_plain"][0] for p in by_path] or [0.0])
        entries.append({
            "name": name, "route": "cuda",
            "source": "grandtpu_torch/csrc/" + (
                "halo.cu" if name.startswith("halo") else "csr_spmm_q8.cu"),
            "replaces": line, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": err, **t,
            "shape": d1["shape"]})
    return entries



# ------------------------------------------------------------ D2 (phases 3h,
# 3i, 9, 9b): data-parallel training on a mesh of shards of the one card


def _mesh(shards: int):
    return make_mesh(shards, devices=[DEV] * shards)


def _state_errors(one, opt1, sharded, opt2, vocab: int) -> dict:
    """max relative error of every parameter, its gradient and Adam moments,
    and every buffer, of the sharded model against the one-device one; a
    joined table's padding rows must be zero. Gradients, moments and
    buffers: relative to the tensor's largest element. Parameter values:
    relative to the model's largest parameter, since Adam's first update
    lr g / (|g| + 1e-8) magnifies an f32 difference of a gradient element
    near 0 up to 1e8 times, and a zero-initialised tensor (a BN bias) is
    after one step nothing but that update."""
    want, got = joined_state(one, opt1), joined_state(sharded, opt2)
    if want.keys() != got.keys():
        raise AssertionError(f"state names differ: {sorted(want)} vs "
                             f"{sorted(got)}")
    scale = max(float(p.detach().abs().max()) for p in one.parameters())
    errs = {}
    for name, w in want.items():
        for i, what in enumerate(("value", "grad", "mu", "nu")[:len(w)]):
            g = got[name][i]
            if (g is None) != (w[i] is None):
                raise AssertionError(f"{name}.{what}: one of the steps has "
                                     f"none")
            if g is None:
                continue
            if name == "table":
                if g[vocab:].any():
                    raise AssertionError(f"table.{what}: a padding row "
                                         f"moved")
                g = g[:vocab]
            if what == "value" and len(w) > 1:
                errs[f"{name}.{what}"] = _errors(g, w[i])[0] / scale
            else:
                errs[f"{name}.{what}"] = _errors(g, w[i])[1]
    return errs


def _synced_ms(fn, iters: int) -> float:
    """Host wall time of one ``fn()`` with the device synchronized (a
    whole step: host dispatch and device work)."""
    fn()
    torch.cuda.synchronize(DEV)
    t0 = time.time()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize(DEV)
    return (time.time() - t0) / iters * 1e3


def _mesh_batch(cfg, n_src: int, n_class: int, g) -> dict:
    nt, nu = cfg.batch_size, cfg.unlabel_batch_size
    lmask = torch.ones(nt, device=DEV)
    lmask[-2:] = 0.0                       # a wrap-padded tail
    return {"rows": torch.randperm(n_src, generator=g, device=DEV)[:nt + nu],
            "labels": torch.randint(0, n_class, (nt,), generator=g,
                                    device=DEV),
            "label_mask": lmask, "unlabel_mask": torch.ones(nu, device=DEV)}


def _collective_bytes(cfg, shards: int, width_in: int, params: int,
                      vocab_parallel: bool) -> dict:
    """Bytes the step's collectives would move between S cards (each
    shard's send, summed; none moves on one card): the BN moments (three
    all-reduces a BatchNorm and augmentation), the gradient sum onto the
    first shard's parameters, and for the vocab-parallel MAG step the
    gather of the batch's top-k rows and masks, the reduce-scatter of the
    [K, B, H] partials and its backward all-gather."""
    s, k = shards, cfg.sample
    b = cfg.batch_size + cfg.unlabel_batch_size
    ar = 2 * (s - 1)                        # reduce, then broadcast
    bn = 0
    if cfg.use_bn:
        widths = ([width_in] if not vocab_parallel else []) + \
            [cfg.hidden] * (cfg.nlayers - 1)
        bn = k * sum(ar * (1 + 2 * w) * 4 for w in widths)
    out = {"bn_moments": bn, "grad_sum": (s - 1) * params * 4}
    if vocab_parallel:
        h = cfg.hidden
        out["topk_rows_and_masks"] = (s - 1) * (b * cfg.top_k * 8
                                                + k * b * cfg.top_k)
        out["partials_reduce_scatter"] = (s - 1) * k * b * h * 4 * 2
        out["grad_all_gather"] = (s - 1) * k * b * h * 4
    out["total"] = sum(out.values())
    return out


def _step_inputs(engine: str, data, padded=None) -> tuple:
    """(cfg, shards, width, operands, model config, batch) of the mesh step
    of phases 9, 9b and 9p: every drop rate of the run on, random top-k
    tables and a batch drawn from a generator seeded with 3 on the card
    (the same in every process)."""
    n_class = data.num_classes
    if engine == "dense":
        # every drop rate on
        cfg = preset("reddit").replace(dataset=DATASET, input_droprate=0.5,
                                       hidden_droprate=0.5)
        shards, nfeat = DENSE_SHARDS, data.num_features
        operands = [torch.as_tensor(np.asarray(data.features, np.float32),
                                    device=DEV)]
    else:
        cfg = preset("mag_scholar_c").replace(dataset=MAG_DATASET)
        shards = MAG_SHARDS
        nfeat = padded.num_features
        operands = [torch.as_tensor(a, device=DEV)
                    for a in (padded.attr_cols, padded.attr_vals)]
    g = torch.Generator(device=DEV).manual_seed(3)
    n_src = len(train_sources(cfg, data))
    operands += [torch.randint(0, data.num_nodes, (n_src, cfg.top_k),
                               generator=g, device=DEV, dtype=torch.int32),
                 torch.rand(n_src, cfg.top_k, generator=g, device=DEV)]
    mcfg = MLPConfig(num_features=nfeat, num_classes=n_class,
                     hidden=cfg.hidden, nlayers=cfg.nlayers,
                     use_bn=cfg.use_bn, node_norm=cfg.node_norm,
                     input_droprate=cfg.input_droprate,
                     hidden_droprate=cfg.hidden_droprate)
    batch = _mesh_batch(cfg, n_src, n_class, g)
    return cfg, shards, nfeat, operands, mcfg, batch


def _step_on(engine: str, cfg, mcfg, model, mesh, operands, batch,
             n_class: int, tp: bool = False):
    """(optimizer, a closure running one step of ``model`` on ``mesh``, or on
    the one card without one, from a generator seeded with the run's
    seed2, and its eval of (rows, labels, mask) given on the card). With
    ``tp`` the model is split over the mesh's 'model' axis (the dense
    MLP's hidden width, the MAG table's columns)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    placed, parts = operands, batch
    if mesh is not None:
        parts = shard_batch(mesh, batch)
        if engine == "dense":
            placed = shard_train_inputs(
                mesh, model=model, features=operands[0],
                tk_cols=operands[1], tk_vals=operands[2],
                tensor_parallel=tp)
        else:
            placed = shard_sparse_train_inputs(
                mesh, model=model, attr_cols=operands[0],
                attr_vals=operands[1], tk_cols=operands[2],
                tk_vals=operands[3], emb_mode="tp" if tp else "vocab")
    opt = make_optimizer(model, cfg.lr, cfg.weight_decay)
    if engine == "dense":
        scfg = StepConfig(
            mlp=mcfg, k_aug=cfg.sample, dropnode_rate=cfg.dropnode_rate,
            n_train=cfg.batch_size, lam=cfg.lam, warmup=cfg.warmup,
            tem=cfg.tem, conf=cfg.resolve_conf(n_class), loss_kind=cfg.loss,
            clip_norm=cfg.clip_norm)
        step = build_train_step(scfg, model, opt, mesh=mesh)
        ev = build_eval_step(scfg, model, mesh=mesh)
    else:
        step, ev = build_sparse_steps(cfg, model, opt, n_class, mesh=mesh)
    gen = torch.Generator(device=DEV).manual_seed(cfg.seed2)

    def evaluate(rows, labels, mask):
        args = (rows, labels, mask)
        if mesh is not None:
            args = tuple(split_rows(mesh, t) for t in args)
        return ev(*placed, *args)

    return opt, lambda: step(*placed, parts, gen, 100), evaluate


def check_mesh_step(engine: str, data, padded=None) -> dict:
    """Phases 9 and 9b, first part: one step on a mesh of the card against
    one one-card step from the same state and generator seed: metrics,
    parameters, gradients, BN buffers and Adam moments within 1e-5; then
    both steps' times and the collectives' bytes."""
    n_class = data.num_classes
    cfg, shards, nfeat, operands, mcfg, batch = _step_inputs(engine, data,
                                                             padded)
    mesh = _mesh(shards)
    torch.backends.cuda.matmul.allow_tf32 = False
    one = (init_mlp if engine == "dense" else init_mag_mlp)(mcfg, cfg.seed2,
                                                            DEV)
    sharded = copy.deepcopy(one)
    opt1, step1, _ = _step_on(engine, cfg, mcfg, one, None, operands, batch,
                              n_class)
    opt2, step2, _ = _step_on(engine, cfg, mcfg, sharded, mesh, operands,
                              batch, n_class)
    m1 = step1()
    m2 = step2()
    torch.cuda.synchronize(DEV)
    errs = {k: _errors(m2[k], m1[k])[1] for k in m1}
    errs.update(_state_errors(one, opt1, sharded, opt2, nfeat))
    worst = max(errs, key=errs.get)
    # the parameters every shard reads (a vocab-sharded table is not)
    n_params = sum(p.numel() for name, p in one.named_parameters()
                   if name != "table")
    one_ms = _synced_ms(step1, 10)
    mesh_ms = _synced_ms(step2, 10)
    nbytes = _collective_bytes(cfg, shards, nfeat, n_params,
                               engine == "mag")
    tag = "9" if engine == "dense" else "9b"
    print(f"[{tag}] one {engine} step on {shards} shards of the card against "
          f"the one-card step (every drop rate of the run on: dropnode "
          f"{cfg.dropnode_rate}, input {cfg.input_droprate}, hidden "
          f"{cfg.hidden_droprate}): {len(errs)} quantities, worst "
          f"{worst} {errs[worst]}; metrics "
          f"{ {k: float(v) for k, v in m2.items()} }; step ms (synchronized "
          f"wall) one-card {one_ms} mesh {mesh_ms}; collective bytes a step "
          f"between {shards} cards {nbytes}", flush=True)
    if errs[worst] > TOL:
        raise AssertionError(f"[{tag}] the mesh step differs from the "
                             f"one-card step: {errs}")
    return {"max_rel_err": errs[worst], "one_card_step_ms": one_ms,
            "mesh_step_ms": mesh_ms, "collective_bytes": nbytes}


def _tp_inputs(engine: str, data, padded=None) -> tuple:
    """:func:`_step_inputs` with every drop rate on (the MAG preset's input
    dropout too: the split step hands each model shard its columns of the
    mask)."""
    cfg, *rest = _step_inputs(engine, data, padded)
    if engine == "mag":
        cfg = cfg.replace(input_droprate=0.5)
    return (cfg, *rest)


def _tp_mesh():
    n_data, n_model = TP_SHAPE
    return make_mesh(n_data, n_model=n_model,
                     devices=[DEV] * (n_data * n_model))


def _tp_eval_rows(cfg, n_src: int, n_class: int) -> tuple:
    """(rows, labels, mask) of an eval of the val set's size (reddit's
    1,230 rows, MAG's 240), drawn from a generator seeded with 4."""
    g = torch.Generator(device=DEV).manual_seed(4)
    n = 1230 if cfg.hidden == 512 else 240
    return (torch.randperm(n_src, generator=g, device=DEV)[:n],
            torch.randint(0, n_class, (n,), generator=g, device=DEV),
            torch.ones(n, device=DEV))


def _step_memory_gb(step, model) -> dict:
    """The model's state on the card (parameters, gradients, Adam's two
    moments) and the peak device memory one synchronized call of ``step``
    adds to what was allocated before it, in GB."""
    state = sum(p.numel() * p.element_size() * 4 for p in model.parameters())
    torch.cuda.synchronize(DEV)
    before = torch.cuda.memory_allocated(DEV)
    torch.cuda.reset_peak_memory_stats(DEV)
    step()
    torch.cuda.synchronize(DEV)
    return {"state_gb": state / 1e9, "step_transient_gb":
            (torch.cuda.max_memory_allocated(DEV) - before) / 1e9}


def check_tp_step(engine: str, data, padded=None) -> dict:
    """Phases 9t and 9tb: the step split over 'model' on a (2 x 2) mesh of
    the card (the dense MLP's hidden width, the MAG table's columns), a
    path of its own: ``TP_STEPS`` steps, every drop rate of the run on,
    then the eval, against the one-card steps and eval from the same state
    and generator seed (metrics, parameters, gradients, BN buffers and Adam
    moments within 1e-5, the blocks joined); exact launches (dense: K1
    once a data row a step and eval, the model shards of a row sharing
    it; MAG: K3's forward and backward once a shard a step, its forward
    once a shard an eval; Adam once a step); then ``TP_TIMED``
    synchronized steps against phase 9's or 9b's data-parallel mesh and the
    one card, and (MAG) the peak device memory of a step against the
    vocab-sharded one's."""
    n_class = data.num_classes
    cfg, shards, nfeat, operands, mcfg, batch = _tp_inputs(engine, data,
                                                           padded)
    tag = "9t" if engine == "dense" else "9tb"
    mesh = _tp_mesh()
    init = init_mlp if engine == "dense" else init_mag_mlp
    one = init(mcfg, cfg.seed2, DEV)
    split = copy.deepcopy(one)
    opt1, step1, eval1 = _step_on(engine, cfg, mcfg, one, None, operands,
                                  batch, n_class)
    opt2, step2, eval2 = _step_on(engine, cfg, mcfg, split, mesh, operands,
                                  batch, n_class, tp=True)
    rows = _tp_eval_rows(cfg, operands[-1].shape[0], n_class)
    m1 = [step1() for _ in range(TP_STEPS)]
    e1 = eval1(*rows)
    torch.cuda.synchronize(DEV)
    _reset_counts()
    m2 = [step2() for _ in range(TP_STEPS)]
    e2 = eval2(*rows)
    torch.cuda.synchronize(DEV)
    launches = _read_counts()
    want = dict.fromkeys(launches, 0)
    want["adam"] = TP_STEPS     # every block on the one card: a launch
    if engine == "dense":
        want["dropnode_mean"] = TP_SHAPE[0] * (TP_STEPS + 1)
    else:
        n = TP_SHAPE[0] * TP_SHAPE[1]
        want["embed_prop_fwd"] = n * (TP_STEPS + 1)
        want["embed_prop_bwd"] = n * TP_STEPS
    errs = {f"step{i}.{k}": _errors(m2[i][k], m1[i][k])[1]
            for i in range(TP_STEPS) for k in m1[i]}
    errs.update(_state_errors(one, opt1, split, opt2, nfeat))
    errs.update({f"eval.{k}": _errors(g, w)[1]
                 for k, g, w in zip(("nll", "acc"), e2, e1)})
    worst = max(errs, key=errs.get)
    if errs[worst] > TOL or launches != want:
        raise AssertionError(f"[{tag}] the split step against one card: "
                             f"{errs}; launches {launches}, want {want}")
    dp = init(mcfg, cfg.seed2, DEV)
    _, step_dp, _ = _step_on(engine, cfg, mcfg, dp, _mesh(shards), operands,
                             batch, n_class)
    times = {"one_card": _synced_ms(step1, TP_TIMED),
             f"data_parallel_{shards}x1": _synced_ms(step_dp, TP_TIMED),
             "tp_{}x{}".format(*TP_SHAPE): _synced_ms(step2, TP_TIMED)}
    peak = {}
    if engine == "mag":
        del one, opt1, step1, eval1
        torch.cuda.empty_cache()
        peak = {"tp": _step_memory_gb(step2, split),
                "vocab": _step_memory_gb(step_dp, dp)}
    print(f"[{tag}] {TP_STEPS} {engine} steps split over 'model' on a "
          f"{TP_SHAPE[0]} x {TP_SHAPE[1]} mesh of the card, then the eval, "
          f"against one card (every drop rate of the run on: dropnode "
          f"{cfg.dropnode_rate}, input {cfg.input_droprate}, hidden "
          f"{cfg.hidden_droprate}; weight decay {cfg.weight_decay}): "
          f"{len(errs)} quantities, worst {worst} {errs[worst]}; first "
          f"step {({k: float(v) for k, v in m2[0].items()})}; launches "
          f"{({k: v for k, v in launches.items() if v})}; step ms "
          f"(synchronized wall, {TP_TIMED} steps) {times}; device memory "
          f"{peak} (9b's vocab-sharded train() peak: "
          f"{PEAK_GB.get('9b')} GB)", flush=True)
    return {"max_rel_err": errs[worst], "worst": worst, "launches": launches,
            "step_ms": times, "peak_gb": peak,
            "first_loss": float(m2[0]["loss"])}


def run_mesh_path(cfg, data, shards: int, tag: str) -> tuple:
    """``train()`` with ``num_devices=shards`` on a mesh of the card, a path
    of its own (counts set to 0 just before, read just after), with exact
    launch counts: dense, K1 once a shard per step and eval; MAG, the K3
    window forms once a shard per step, the full K3 once a shard per eval
    and once per predict chunk; D1's hops ``order`` times a shard; Adam
    once a step; nothing else."""
    mesh = _mesh(shards)
    cfg = cfg.replace(num_devices=shards)
    _reset_counts()
    torch.cuda.reset_peak_memory_stats(DEV)
    t0 = time.time()
    r = train(cfg, data=data, device=DEV, mesh=mesh)
    wall = time.time() - t0
    launches = _read_counts()
    PEAK_GB[tag] = torch.cuda.max_memory_allocated(DEV) / 1e9
    steps, evals = r.num_batches, len(r.history)
    want = dict.fromkeys(launches, 0)
    want["csr_spmm_prop"] = cfg.order * shards
    want["adam"] = steps        # every shard's leaves on the one card
    if data.has_sparse_features:
        want["embed_prop_window_fwd"] = shards * steps
        want["embed_prop_window_bwd"] = shards * steps
        want["embed_prop_fwd"] = (shards * evals
                                  + -(-data.num_nodes // K3_SHAPE[4]))
    else:
        want["dropnode_mean"] = shards * (steps + evals)
    print(f"[{tag}] train(num_devices={shards}, mesh of the card) "
          f"{cfg.dataset}, {cfg.epochs} epochs: steps {steps}, evals "
          f"{evals}, launches { {k: v for k, v in launches.items() if v} }, "
          f"test_acc {r.test_acc}, best_val_acc {r.best_val_acc}, "
          f"preprocess_s {r.preprocess_time}, batch_time_median_s "
          f"{r.batch_time_median}, propagate_s {r.propagate_time}, total_s "
          f"{r.total_time}, train_call_s {wall}, peak_mem_GB {PEAK_GB[tag]}",
          flush=True)
    losses = [v for h in r.history for v in (h["loss"], h["val_loss"])]
    if not (r.history and np.all(np.isfinite(losses))
            and 0.0 <= r.test_acc <= 1.0):
        raise AssertionError(f"[{tag}] history {r.history}, test_acc "
                             f"{r.test_acc}")
    if launches != want:
        raise AssertionError(f"[{tag}] launches {launches}, want {want}")
    return r, launches


def _window_bytes(shard_rows: int, lo: int, hi: int, s: dict, num_aug: int):
    """Least bytes and ops of one K3 window forward and backward on set
    ``s``: the window's distinct gathered rows once, the ids and values of
    the rows' nodes, the top-k rows and the mask once, the output (and for
    the backward the grad) once; the backward zero-fills the window."""
    h = H_MAG
    idx = s["tk_cols"].long()
    ids = s["attr_cols"][idx]
    live = s["attr_vals"][idx] != 0
    inside = live & (ids >= lo) & (ids < hi)
    uniq = torch.unique(ids[inside]).numel()
    rows, ktop = s["tk_cols"].shape
    p = s["attr_cols"].shape[1]
    common = (torch.unique(s["tk_cols"]).numel() * p * 8 + rows * ktop * 8
              + s["keep"].numel())
    out = num_aug * rows * h * 4
    flops = 2 * int(inside.sum()) * h + 2 * num_aug * rows * ktop * h
    return (uniq * h * 4 + common + out, flops,
            shard_rows * h * 4 + common + out, flops)


def check_k3_window(padded) -> list:
    """Phase 3h: K3's window forms over the 4 vocab windows of the MAG
    table at the MAG step's shapes (every row of the batch over each
    window, as the vocab-parallel step runs them), against their plain
    versions; the windows' forwards summed against the full K3, their
    gradients joined against the full backward; times and bounds."""
    g = torch.Generator(device=DEV).manual_seed(2)
    v, h, shards = padded.num_features, H_MAG, MAG_SHARDS
    per = -(-v // shards)
    table = torch.randn(per * shards, h, generator=g, device=DEV)
    table[v:] = 0.0
    attr_cols = torch.as_tensor(padded.attr_cols, device=DEV)
    attr_vals = torch.as_tensor(padded.attr_vals, device=DEV)
    sets = _k3_form_sets(attr_cols, attr_vals, "train", g)
    num_aug = sets[0]["keep"].shape[0]
    wins = [(s * per, (s + 1) * per) for s in range(shards)]
    shard_t = [table[lo:hi].clone().requires_grad_(True) for lo, hi in wins]
    full_t = table[:v].clone().requires_grad_(True)
    s0 = sets[0]
    full = embed_prop(full_t, **s0)
    gout = torch.randn(full.shape, generator=g, device=DEV)
    d_full, = torch.autograd.grad(full, full_t, gout)
    outs, grads, e_f, e_b = [], [], [0.0, 0.0], [0.0, 0.0]
    bits_b = True
    for t, (lo, hi) in zip(shard_t, wins):
        out = embed_prop_window(t, lo, hi, **s0)
        d_k, = torch.autograd.grad(out, t, gout)
        plain = embed_prop_plain(t, **s0, vocab_lo=lo, vocab_hi=hi)
        d_p, = torch.autograd.grad(plain, t, gout)
        e_pb, bits = _k3_backward_checked(d_k, gout, lo, hi, s0, 0.0,
                                          f"window [{lo}, {hi})")
        bits_b = bits_b and bits
        ef, eb = _errors(out.detach(), plain.detach()), _errors(d_k, d_p)
        e_f = [max(a, b) for a, b in zip(e_f, ef)]
        e_b = [max(a, b, c) for a, b, c in zip(e_b, eb, e_pb)]
        outs.append(out.detach())
        grads.append(d_k)
    e_sum = _errors(sum(outs), full.detach())
    joined = torch.cat(grads)
    e_cat = _errors(joined[:v], d_full)
    pad_zero = not joined[v:].any()
    print(f"[3h] K3 window forms on {shards} windows of {per} rows "
          f"([{num_aug},{s0['tk_cols'].shape[0]},{h}] each): fwd vs plain "
          f"{e_f}, bwd vs plain {e_b}; windows summed vs the full K3 "
          f"{e_sum}, gradients joined vs the full backward {e_cat}, "
          f"padding rows' gradient zero {pad_zero}, bwd bit for bit its "
          f"plain version {bits_b}", flush=True)
    if not (e_f[1] <= TOL and e_b[1] <= TOL and e_sum[1] <= TOL
            and e_cat[1] <= TOL and pad_zero):
        raise AssertionError("[3h] the K3 window forms disagree")
    del outs, grads, joined, d_full, full

    # times: every (window, set) in turn, as a step runs the 4 windows
    cases = [(t, lo, hi, st) for st in sets for t, (lo, hi) in
             zip(shard_t, wins)]
    it = itertools.cycle(cases)

    def fwd_next(fn):
        t, lo, hi, st = next(it)
        if fn is embed_prop_window:
            return fn(t, lo, hi, **st)
        return fn(t, **st, vocab_lo=lo, vocab_hi=hi)

    with torch.no_grad():
        ms_f = _time_ms(lambda: fwd_next(embed_prop_window), 200)
        dev_f = _device_ms(lambda: fwd_next(embed_prop_window), 100,
                           "embed_prop_fwd_kernel")
        plain_f = _time_ms(lambda: fwd_next(embed_prop_plain), 16)
    outs = [embed_prop_window(t, lo, hi, **st) for t, lo, hi, st in cases]
    it_o = itertools.cycle(zip(outs, cases))
    # autograd's wall (host dispatch included); every device operation of
    # one call (no sort may run)
    ms_b = _time_ms(lambda: _window_grad(next(it_o), gout), 64)
    dev_b, by_kernel = _call_device_ms(
        lambda: _window_grad(next(it_o), gout), 32)
    sort_b = _no_sort(_sort_ms(lambda: _window_grad(next(it_o), gout), 32),
                      "over a window")
    plains = [embed_prop_plain(t, **st, vocab_lo=lo, vocab_hi=hi)
              for t, lo, hi, st in cases[:8]]
    it_p = itertools.cycle(zip(plains, cases))
    plain_b = _time_ms(lambda: _window_grad(next(it_p), gout), 16)
    # the library yardstick: embedding_bag over the window, ids outside it
    # weighted 0 (with the full rows' weights it is the same function
    # when nothing is dropped; timed only)
    libs = []
    for t, lo, hi, st in cases:
        ids, w = _k3_library(None, st)
        inside = (ids >= lo) & (ids < hi)
        libs.append((torch.where(inside, ids - lo, 0),
                     torch.where(inside, w, 0.0), t))
    it_l = itertools.cycle(libs)

    def bag(lib):
        return F.embedding_bag(lib[0], lib[2], mode="sum",
                               per_sample_weights=lib[1])

    with torch.no_grad():
        lib_err = _errors(bag(libs[0]),
                          outs[0].detach().reshape(-1, h))[1]
        lib_f = _time_ms(lambda: bag(next(it_l)), 200)
    lib_outs = [bag(lb) for lb in libs[:8]]
    lg = torch.randn(lib_outs[0].shape, generator=g, device=DEV)
    it_lo = itertools.cycle(zip(lib_outs, libs))
    def lib_grad():
        o = next(it_lo)
        return torch.autograd.grad(o[0], o[1][2], lg, retain_graph=True)

    lib_b = _time_ms(lib_grad, 32)
    lib_dev_b = _call_device_ms(lib_grad, 32)[0]
    # where the backward's time goes: the function called directly (no
    # autograd), and its zero-fill alone; the same for the full table
    ktop_p = (s0["tk_cols"].shape[1], s0["attr_cols"].shape[1])
    dims = (s0["tk_cols"].shape[0], *ktop_p, h, num_aug)
    saved = (s0["attr_cols"], s0["attr_vals"], s0["tk_cols"],
             s0["tk_vals"], s0["keep"], None, 0.0, dims)
    direct = {
        "window_call_ms": _time_ms(lambda: embed_prop_window_backward(
            gout, 0, per, *saved), 64),
        "window_fill_ms": _time_ms(lambda: torch.zeros((per, h),
                                                       device=DEV), 64),
        "full_call_ms": _time_ms(lambda: embed_prop_backward(
            gout, v, *saved), 32),
        "full_fill_ms": _time_ms(lambda: torch.zeros((v, h), device=DEV),
                                 32)}
    print(f"[3h] backward called directly (no autograd): {direct}",
          flush=True)
    nb = [_window_bytes(per, lo, hi, st, num_aug) for _, lo, hi, st in cases]
    b_f, o_f, b_b, o_b = (float(np.mean([x[i] for x in nb]))
                          for i in range(4))
    (bound_f, by_f), (bound_b, by_b) = _bound(b_f, o_f), _bound(b_b, o_b)
    scratch = float(np.mean([_k3_scratch_bytes(st, h, lo, hi)
                             for _, lo, hi, st in cases]))
    bound_scratch = _bound(b_b + scratch, o_b)[0]
    print(f"[3h] per window call: fwd ms {ms_f} (on the device, profiled: "
          f"{dev_f}) plain_ms {plain_f} library_ms {lib_f} (embedding_bag, "
          f"{lib_err} from the kernel) bound_ms {bound_f} ({by_f}, "
          f"{b_f / 1e6:.3f} MB); bwd ms through autograd {ms_b} (on the "
          f"device, profiled: every operation {dev_b}, {by_kernel}; sort "
          f"{sort_b}) plain_ms {plain_b} library_ms {lib_b} (on the device "
          f"{lib_dev_b}) bound_ms {bound_b} ({by_b}, {b_b / 1e6:.1f} MB; "
          f"with the scratch {bound_scratch}, +{scratch / 1e6:.2f} MB)",
          flush=True)
    shape = (f"[{num_aug},{s0['tk_cols'].shape[0]},{h}] over a window of "
             f"{per} of {v} rows")
    entries = []
    for key, line, err, ms, dev, plain_ms, lib, bound, by in (
            ("fwd", 80, e_f, ms_f, dev_f, plain_f, lib_f, bound_f, by_f),
            ("bwd", 87, e_b, ms_b, dev_b, plain_b, lib_b, bound_b, by_b)):
        entries.append({
            "name": f"embed_prop_window_{key}", "route": "cuda",
            "source": "grandtpu_torch/csrc/embed_prop.cu",
            "replaces": f"grandtpu/nn/sparse_input.py:{line}",
            "sharded_by": "grandtpu/dist/data_parallel.py:96",
            "max_abs_err": err[0], "max_rel_err": err[1],
            "windows_vs_full": e_sum[1] if key == "fwd" else e_cat[1],
            "ms": ms, "device_ms": dev, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib,
            "shape": shape})
    entries[1].update(direct=direct, by_kernel_ms=by_kernel,
                      sort_device_ms=sort_b, library_device_ms=lib_dev_b,
                      plain_bits_equal=bits_b,
                      bound_with_scratch_ms=bound_scratch)
    return entries


def _window_grad(out_case, gout):
    out, (t, _, _, _) = out_case
    return torch.autograd.grad(out, t, gout, retain_graph=True)


def _sharded_push_path(mesh, axis: str, inputs: tuple, cfg,
                       push_reddit: dict, tag: str) -> tuple:
    """``sharded_gfpush`` along ``axis`` of ``mesh`` (shards of the card)
    over 3e's sources, a path of its own: P1's launches on every shard
    (each group along the axis pushes every source), within the row rule
    of 3e's one-card P1. Returns (the tables, launches, sources/s, bit for
    bit the one-card P1)."""
    indptr, indices, sources, coef = inputs
    _reset_counts()
    t0 = time.time()
    got = sharded_gfpush(mesh, indptr, indices, sources, coef, cfg.rmax,
                         cfg.top_k, axis=axis)
    seconds = time.time() - t0
    launches = _read_counts()
    per = -(-len(sources) // mesh.shape[axis])
    blocks = mesh.size * -(-per // 512)
    want = dict.fromkeys(launches, 0)
    want.update(dense_push_mask=blocks * (cfg.order + 1),
                csr_spmm_prop=blocks * cfg.order, push_topk=blocks)
    one = push_reddit["tables"]["jax"]
    _row_rule(one[0], one[1], *got, max(1e-5, 2 * cfg.rmax))
    same = _same(got, one)
    sps = len(sources) / seconds
    print(f"[{tag}] sharded_gfpush along '{axis}' of a {mesh.n_data} x "
          f"{mesh.n_model} mesh of the card: {len(sources)} sources ({per} "
          f"a shard, groups {mesh.size // mesh.shape[axis]}) in {seconds} s "
          f"= {sps} sources/s (one-card P1, 3e: {push_reddit['sps']['jax']});"
          f" launches { {k: v for k, v in launches.items() if v} }; within "
          f"the row rule of the one-card P1, bit for bit {same}", flush=True)
    if launches != want:
        raise AssertionError(f"[{tag}] launches {launches}, want {want}")
    return got, {"launches": launches, "sources_per_s": sps, "same": same}


def _push_inputs(data, cfg) -> tuple:
    adj_sl = add_self_loops_adj(data.adj)
    return (np.asarray(adj_sl.indptr, np.int32),
            np.asarray(adj_sl.indices, np.int32), train_sources(cfg, data),
            np.asarray(build_coef(cfg.prop_mode, cfg.order, cfg.alpha),
                       np.float32))


def check_sharded_push(data, cfg, push_reddit: dict) -> dict:
    """Phase 3i: ``sharded_gfpush`` on 4 shards of the card over 3e's
    sources, a path of its own, against the one-card P1 under the row rule;
    P1's launches per shard; sources/s beside 3e's P1."""
    return _sharded_push_path(_mesh(SHARDS), "data",
                              _push_inputs(data, cfg), cfg, push_reddit,
                              "3i")[1]


def check_sharded_push_2d(data, cfg, push_reddit: dict) -> dict:
    """Phase 3m (8m's push, here where 3e's reddit tables are):
    ``sharded_gfpush`` on the (2 x 2) mesh of the card (TP_SHAPE) along
    'data' and along 'model', each a path as 3i's, and each equal to the
    push on a 1-D mesh of 2 shards of the card, element for element."""
    inputs = _push_inputs(data, cfg)
    n_data, n_model = TP_SHAPE
    mesh = make_mesh(n_data, n_model=n_model,
                     devices=[DEV] * (n_data * n_model))
    flat, _ = _sharded_push_path(_mesh(n_data), "data", inputs, cfg,
                                 push_reddit, "3m")
    out = {}
    for axis in ("data", "model"):
        got, res = _sharded_push_path(mesh, axis, inputs, cfg, push_reddit,
                                      "3m")
        res["equal_1d"] = _same(got, flat)
        print(f"[3m] along '{axis}': equal to the 1-D mesh's tables "
              f"{res['equal_1d']}", flush=True)
        if not res["equal_1d"]:
            raise AssertionError(f"[3m] along '{axis}': the tables differ "
                                 f"from the 1-D mesh's")
        out[axis] = res
    return out


# ------------------------------------------------- 9p: a mesh over processes


PROC_RANKS = 2                      # 9p's ranks, processes on the one card
PROC_TIMEOUT = 420                  # seconds the ranks may take in all
PROC_DIR = os.path.join("build", "chip_smoke_9p")
RANK_COMMAND = [sys.executable, os.path.abspath(__file__)]   # a 9p rank
# 9p's D1 runs on one shard a rank: (name, halo_threshold, precision)
PROC_D1 = (("all_gather_f32", 0.0, "f32"), ("all_gather_int8", 0.0, "int8"),
           ("halo_f32", float("inf"), "f32"),
           ("halo_int8", float("inf"), "int8"))
# 9p's 2-D process meshes ((n_data, n_model), axis), each running
# PROC_D1's all_gather forms: the model columns of a (2 x 2) mesh span the
# ranks ('model' inside each), the data row of a (1 x 2) mesh spans them
PROC_D1_2D = (((2, 2), "data"), ((1, 2), "model"))


def _emit(part: str, **kw) -> None:
    """One JSON line of a 9p rank, which the parent reads."""
    print("[9p] " + json.dumps({"part": part, **kw}, default=float),
          flush=True)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _replicas(model) -> list:
    """What every rank must hold bit for bit: the model's parameters and
    buffers, a vocab-sharded table gathered (a collective)."""
    out = [t for n, t in [*model.named_parameters(), *model.named_buffers()]
           if not n.startswith("table_shards.")]
    if getattr(model, "vocab_mesh", None) is not None:
        out.append(model.gathered_table())
    return out


def _gloo_cuda_coverage() -> dict:
    """Which collectives this torch's gloo takes card tensors for, each
    tried once on a small card tensor (the mesh stages card tensors
    through host memory for every collective all the same)."""
    world = tdist.get_world_size()

    def z(n=2):
        return torch.ones(n, device=DEV)

    tries = {
        "all_reduce": lambda: tdist.all_reduce(z()),
        "broadcast": lambda: tdist.broadcast(z(), 0),
        "all_gather": lambda: tdist.all_gather([z() for _ in range(world)],
                                               z()),
        "all_gather_into_tensor": lambda: tdist.all_gather_into_tensor(
            z(2 * world), z()),
        "reduce_scatter": lambda: tdist.reduce_scatter(
            z(), [z() for _ in range(world)]),
        "reduce_scatter_tensor": lambda: tdist.reduce_scatter_tensor(
            z(), z(2 * world)),
        "all_to_all": lambda: tdist.all_to_all([z() for _ in range(world)],
                                               [z() for _ in range(world)]),
        "all_to_all_single": lambda: tdist.all_to_all_single(
            z(2 * world), z(2 * world)),
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            torch.cuda.synchronize(DEV)
            out[name] = "covered"
        except Exception as e:   # a report of the build, not a fall-back
            out[name] = (f"{type(e).__name__}: "
                         f"{(str(e).splitlines() or [''])[0][:160]}")
    return out


def _proc_step(engine: str, data, padded=None) -> dict:
    """9p: one step of the mesh over the ranks against the one-process mesh
    of the card (phase 9's for reddit, 9b's for MAG) from the same state,
    inputs and seeds: the loss and every parameter within 1e-5 (values
    relative to the model's largest), the gathered table too; then the
    step's synchronized time, and the transport's seconds within it."""
    n_class = data.num_classes
    cfg, shards, _, operands, mcfg, batch = _step_inputs(engine, data,
                                                         padded)
    proc = (init_mlp if engine == "dense" else init_mag_mlp)(mcfg, cfg.seed2,
                                                             DEV)
    one = copy.deepcopy(proc)
    _, step1, _ = _step_on(engine, cfg, mcfg, one, Mesh((DEV,) * shards),
                           operands, batch, n_class)
    mesh = make_mesh(shards)
    _, step2, _ = _step_on(engine, cfg, mcfg, proc, mesh, operands, batch,
                           n_class)
    m1, m2 = step1(), step2()
    torch.cuda.synchronize(DEV)
    errs = {k: _errors(m2[k], m1[k])[1] for k in m1}
    scale = max(float(p.detach().abs().max()) for p in _replicas(one))
    want = dict(one.named_parameters())
    for name, p in proc.named_parameters():
        if not name.startswith("table_shards."):
            errs[name] = _errors(p, want[name])[0] / scale
    if engine == "mag":
        errs["table"] = _errors(proc.gathered_table(),
                                one.gathered_table())[0] / scale
    worst = max(errs, key=errs.get)
    del one, step1, want
    torch.cuda.empty_cache()
    step2()
    torch.cuda.synchronize(DEV)
    reset_transport()
    t0 = time.time()
    for _ in range(10):
        step2()
    torch.cuda.synchronize(DEV)
    step_ms = (time.time() - t0) / 10 * 1e3
    transport = {k: v / 10 for k, v in TRANSPORT.items()}
    if errs[worst] > TOL:
        raise AssertionError(f"[9p] the {engine} step over the ranks differs "
                             f"from the one-process mesh's: {errs}")
    return {"shards": list(mesh.shards), "worst": worst,
            "max_rel_err": errs[worst], "loss": float(m2["loss"]),
            "step_ms": step_ms, "transport_a_step": transport,
            "transport_share": (transport["stage_s"] + transport["comm_s"])
            * 1e3 / step_ms}


def _proc_tp_step(engine: str, data, padded=None) -> dict:
    """9p, tp: the step split over 'model' on a (1 x 2) mesh whose model
    shards are the 2 ranks (each holds one column block), against the
    one-process (1 x 2) mesh of the card from the same state, inputs and
    seeds (metrics and the joined parameters within 1e-5, values relative
    to the model's largest); then 10 synchronized steps, their launches (a
    path: counts set to 0 before, read after) and the transport's calls,
    bytes and seconds a step. The whole parameters' digest goes to the
    parent, which holds the ranks to each other."""
    n_class = data.num_classes
    cfg, _, _, operands, mcfg, batch = _tp_inputs(engine, data, padded)
    proc = (init_mlp if engine == "dense" else init_mag_mlp)(mcfg, cfg.seed2,
                                                             DEV)
    one = copy.deepcopy(proc)
    _, step1, _ = _step_on(engine, cfg, mcfg, one, Mesh((DEV,) * 2,
                                                        n_model=2),
                           operands, batch, n_class, tp=True)
    mesh = make_mesh(1, n_model=2)
    if mesh.model_group != (0, 1) or len(mesh.local_columns) != 1:
        raise AssertionError(f"[9p] tp: 'model' does not span the ranks: "
                             f"{mesh}")
    _, step2, _ = _step_on(engine, cfg, mcfg, proc, mesh, operands, batch,
                           n_class, tp=True)
    m1 = step1()
    torch.cuda.synchronize(DEV)
    _reset_counts()
    reset_transport()
    m2 = step2()
    torch.cuda.synchronize(DEV)
    first = dict(TRANSPORT)
    errs = {k: _errors(m2[k], m1[k])[1] for k in m1}
    # the whole trees (joining the blocks is a collective of the ranks)
    want, got = (_flatten_with_paths(dict(zip(("params", "state"),
                                              model_trees(m))))
                 for m in (one, proc))
    scale = max(float(np.abs(w).max()) for w in want.values())
    for key, w in want.items():
        errs[key] = float(np.abs(got[key] - w).max()) / scale
    worst = max(errs, key=errs.get)
    digest = _digest(torch.as_tensor(got[k]) for k in sorted(got))
    del one, step1
    torch.cuda.empty_cache()
    reset_transport()
    t0 = time.time()
    for _ in range(10):
        step2()
    torch.cuda.synchronize(DEV)
    step_ms = (time.time() - t0) / 10 * 1e3
    launches = {k: v for k, v in _read_counts().items() if v}
    transport = {k: v / 10 for k, v in TRANSPORT.items()}
    if errs[worst] > TOL:
        raise AssertionError(f"[9p] the {engine} step split over the ranks "
                             f"differs from the one-process mesh's: {errs}")
    return {"columns": list(mesh.local_columns), "worst": worst,
            "max_rel_err": errs[worst], "loss": float(m2["loss"]),
            "digest": digest, "step_ms": step_ms, "launches": launches,
            "transport_first_step": first, "transport_a_step": transport,
            "transport_share": (transport["stage_s"] + transport["comm_s"])
            * 1e3 / step_ms}


def _proc_want(cfg, data, r, local: int) -> dict:
    """The launches a rank's ``train()`` must make: its shards' share."""
    want = dict.fromkeys(COUNTED, 0)
    halo = estimate_halo_compression(add_self_loops_adj(data.adj),
                                     cfg.num_devices) < 0.5
    for name in (("halo_pack", "halo_hop") if halo else ("csr_spmm_prop",)):
        want[name] = cfg.order * local
    steps, evals = r.num_batches, len(r.history)
    want["adam"] = steps        # a rank's leaves are on its one card
    if data.has_sparse_features:
        want["embed_prop_window_fwd"] = local * steps
        want["embed_prop_window_bwd"] = local * steps
        want["embed_prop_fwd"] = (local * evals
                                  + -(-data.num_nodes // K3_SHAPE[4]))
    else:
        want["dropnode_mean"] = local * (steps + evals)
    return want


def _proc_train(cfg, data) -> dict:
    """9p: ``train()`` over the ranks (``num_devices`` the global shard
    count, the mesh ``make_mesh``'s), a path of its own: counts set to 0
    just before and read just after; each rank's launches its own shards'
    share; the checkpoint writes counted (rank 0 alone writes)."""
    writes = []
    real = loop_mod.save_checkpoint
    loop_mod.save_checkpoint = lambda *a, **k: writes.append(real(*a, **k))
    try:
        _reset_counts()
        reset_transport()
        t0 = time.time()
        r = train(cfg, data=data, device=DEV)
        wall = time.time() - t0
        launches = _read_counts()
        transport = dict(TRANSPORT)
    finally:
        loop_mod.save_checkpoint = real
    local = cfg.num_devices // PROC_RANKS
    want = _proc_want(cfg, data, r, local)
    losses = [v for h in r.history for v in (h["loss"], h["val_loss"])]
    if not (r.history and np.all(np.isfinite(losses))):
        raise AssertionError(f"[9p] history {r.history}")
    if launches != want:
        raise AssertionError(f"[9p] {cfg.dataset}: launches {launches}, want "
                             f"{want}")
    rank = tdist.get_rank()
    # the npz is rank 0's alone; every rank takes part in a directory save
    writer = rank == 0 or cfg.ckpt_backend == "orbax"
    if cfg.ckpt_dir and not (writes and all(w == writer for w in writes)):
        raise AssertionError(f"[9p] rank {rank} checkpoint writes {writes}")
    files = []
    if cfg.ckpt_backend == "orbax":
        best = os.path.join(cfg.ckpt_dir, "best")
        files = sorted((f, os.path.getsize(os.path.join(best, f)))
                       for f in os.listdir(best))
    return {"launches": {k: v for k, v in launches.items() if v},
            "ckpt_files": files,
            "steps": r.num_batches, "history": r.history,
            "test_acc": r.test_acc, "n_test": len(data.idx_test),
            "best_val_acc": r.best_val_acc,
            "batch_time_median_s": r.batch_time_median,
            "propagate_s": r.propagate_time, "total_s": r.total_time,
            "train_call_s": wall, "digest": _digest(_replicas(r.model)),
            "writes": writes, "transport": transport}


def _proc_d1(data, cfg) -> dict:
    """9p: ``dist_exact_propagate`` over the ranks (one shard each) on the
    reddit operator, all_gather and halo at f32 and int8, each a path of
    its own with its launches: f32 within 1e-5 of the one-card
    ``exact_propagate``, int8 within 1e-3 of the one-process mesh's int8
    run of the same variant; the default threshold 0.5. Then the
    all_gather runs on the 2-D process meshes of PROC_D1_2D, every local
    group's result bit for bit the 1-D run's."""
    adj = add_self_loops_adj(data.adj)
    x = torch.as_tensor(np.asarray(data.features, np.float32), device=DEV)
    kw = dict(mode=cfg.prop_mode, order=cfg.order, alpha=cfg.alpha)
    mesh, one = make_mesh(PROC_RANKS), Mesh((DEV,) * PROC_RANKS)
    threshold = default_halo_threshold(mesh)
    auto = type(dist_exact_propagator(mesh, adj, x.shape[1])[0]).__name__
    if threshold != 0.5:
        raise AssertionError(f"[9p] default halo threshold {threshold}")
    ref = exact_propagate(adj, x, device=DEV, **kw)
    out = {"default_threshold": threshold, "default_propagator": auto,
           "compression": estimate_halo_compression(adj, PROC_RANKS),
           "runs": {}}
    meshes = [("", mesh, "data", PROC_D1)] + [
        (f"_{a}x{b}_{axis}", make_mesh(a, n_model=b), axis, PROC_D1[:2])
        for (a, b), axis in PROC_D1_2D]
    for suffix, m, axis, runs in meshes:
        for name, thr, precision in runs:
            prop, p = dist_exact_propagator(m, adj, x.shape[1], axis=axis,
                                            halo_threshold=thr,
                                            precision=precision)
            _reset_counts()
            reset_transport()
            t0 = time.time()
            outs = prop.each(x, precision=p, **kw)
            torch.cuda.synchronize(DEV)
            hops_s = time.time() - t0
            launches = _read_counts()
            transport = dict(TRANSPORT)
            got, digest = outs[0], _digest(outs[:1])
            same = all(torch.equal(o, got) for o in outs[1:])
            if suffix:
                # the 2-D run bit for bit the 1-D process run of its form,
                # whose error an int8 run then shares
                base = out["runs"][name]
                same = same and digest == base["digest"]
                err, limit = ((_errors(got, ref)[1], TOL) if precision
                              == "f32" else (base["max_rel_err"],
                                             base["limit"]))
            elif precision == "f32":
                err, limit = _errors(got, ref)[1], TOL
            else:
                oprop, op = dist_exact_propagator(one, adj, x.shape[1],
                                                  halo_threshold=thr,
                                                  precision=precision)
                err, limit = _errors(got, oprop(x, precision=op,
                                                **kw))[1], 1e-3
                del oprop
            kernels = {"all_gather_f32": {"csr_spmm_prop"},
                       "halo_f32": {"halo_pack", "halo_hop"},
                       "halo_int8": {"column_absmax", "halo_pack",
                                     "halo_hop"},
                       "all_gather_int8": {
                           "column_absmax", "quantize_with_amax",
                           "csr_spmm_q8mxu" if prop.g.row_val is not None
                           else "csr_spmm_q8"}}[name]
            local = len(m.shards)
            want = {k: (local if (name, k) == ("all_gather_int8",
                                               "column_absmax")
                        else cfg.order * local) if k in kernels else 0
                    for k in launches}
            if (launches != want or err > limit or got.shape != x.shape
                    or not same):
                raise AssertionError(
                    f"[9p] D1 {name}{suffix}: launches {launches} (want "
                    f"{want}), error {err} (limit {limit}), shape "
                    f"{tuple(got.shape)}, the groups and the 1-D run "
                    f"equal {same}")
            out["runs"][name + suffix] = {
                "propagator": type(prop).__name__, "groups": len(outs),
                "launches": {k: v for k, v in launches.items() if v},
                "max_rel_err": err, "limit": limit, "hops_s": hops_s,
                "transport": transport, "digest": digest}
            del prop, outs, got
    return out


def _proc_push(cfg, data) -> dict:
    """9p: ``multihost_native_gfpush`` of the reddit sources over the ranks
    against the native push of one process: cols and vals equal."""
    adj = add_self_loops_adj(data.adj)
    sources = train_sources(cfg, data)
    kw = dict(prop_mode=cfg.prop_mode, order=cfg.order, alpha=cfg.alpha,
              rmax=cfg.rmax, k=cfg.top_k, backend="native")
    t0 = time.time()
    got = multihost_native_gfpush(adj, sources, **kw)
    multi_s = time.time() - t0
    t0 = time.time()
    want = gfpush(adj, sources, **kw)
    one_s = time.time() - t0
    same = _same((got.cols, got.vals), (want.cols, want.vals))
    if not same:
        raise AssertionError("[9p] the push over the ranks differs from the "
                             "one-process native push")
    return {"sources": len(sources), "equal": same, "multihost_s": multi_s,
            "one_process_s": one_s}


def _proc_nccl_refusal(rank: int, port: int) -> str:
    """9p: the nccl backend with both ranks on the card: make_mesh refuses
    it, naming gloo."""
    tdist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                             world_size=PROC_RANKS, rank=rank)
    try:
        make_mesh(PROC_RANKS)
    except RuntimeError as e:
        message = str(e)
    else:
        raise AssertionError("[9p] NCCL took two ranks on one card")
    finally:
        tdist.destroy_process_group()
    if "two ranks on one card" not in message or "gloo" not in message:
        raise AssertionError(f"[9p] the refusal does not name its cause: "
                             f"{message}")
    return message


def rank_main(argv) -> int:
    """One rank of 9p: ``chip_smoke.py --rank RANK PORT,PORT DIR``."""
    rank, ports, workdir = int(argv[0]), argv[1].split(","), argv[2]
    torch.cuda.set_device(DEV)
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:"
                             f"{ports[0]}", world_size=PROC_RANKS, rank=rank)
    t0 = time.time()
    _emit("gloo_cuda", coverage=_gloo_cuda_coverage())
    data = load_data(DATASET, split_seed=preset("reddit").seed1)
    _emit("reddit_step", **_proc_step("dense", data))
    _emit("reddit_tp", **_proc_tp_step("dense", data))
    cfg = preset("reddit").replace(
        dataset=DATASET, epochs=2, num_devices=PROC_RANKS,
        ckpt_dir=os.path.join(workdir, "ckpt"))
    _emit("reddit_train", **_proc_train(cfg, data))
    _emit("reddit_train_dir", **_proc_train(cfg.replace(
        ckpt_dir=os.path.join(workdir, "ckpt_dir"), ckpt_backend="orbax"),
        data))
    _emit("d1", **_proc_d1(data, cfg))
    _emit("push", **_proc_push(cfg, data))
    del data
    torch.cuda.empty_cache()
    mag = load_data(MAG_DATASET, split_seed=preset("mag_scholar_c").seed1)
    padded = PaddedFeatures.from_csr(mag.features)
    _emit("mag_step", **_proc_step("mag", mag, padded))
    _emit("mag_tp", **_proc_tp_step("mag", mag, padded))
    del padded
    torch.cuda.empty_cache()
    mag_cfg = preset("mag_scholar_c").replace(
        dataset=MAG_DATASET, epochs=5, num_devices=MAG_SHARDS,
        ckpt_dir=os.path.join(workdir, "mag_ckpt"))
    _emit("mag_train", **_proc_train(mag_cfg, mag))
    _emit("mag_train_dir", **_proc_train(mag_cfg.replace(
        ckpt_dir=os.path.join(workdir, "mag_ckpt_dir"),
        ckpt_backend="orbax"), mag))
    del mag
    tdist.destroy_process_group()
    _emit("nccl_refusal", message=_proc_nccl_refusal(rank, int(ports[1])),
          wall_s=time.time() - t0)
    print(f"RANK{rank} OK", flush=True)
    return 0


def _rank_parts(log: str) -> dict:
    parts = {}
    with open(log) as f:
        for line in f:
            if line.startswith("[9p] {"):
                rec = json.loads(line[5:])
                parts[rec.pop("part")] = rec
    return parts


def _predict_ckpt(ckpt: str) -> float:
    """The predict CLI on the one card from the ranks' best.npz: its
    test accuracy."""
    argv = ["predict", "--preset", "reddit", "--dataset", DATASET, "--ckpt",
            ckpt, "--precision", "f32", "--output",
            os.path.join(os.path.dirname(ckpt), "predictions.npz")]
    stdout, stderr = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(stdout), \
            contextlib.redirect_stderr(stderr):
        rc = cli(argv)
    if rc != 0:
        raise AssertionError(f"[9p] predict exited {rc}: "
                             f"{stderr.getvalue()[-2000:]}")
    return json.loads(stdout.getvalue().strip().splitlines()[-1])["test_acc"]


def _proc_directories(a: dict, b: dict) -> float:
    """9p with ``ckpt_backend="orbax"``: each engine's run over the ranks
    again with the directory checkpoints. Every rank took part in each
    save (each wrote its ``.distcp`` file), the run is the npz run's bit
    for bit (history and parameter digest on both ranks), and ``best/``
    restored here, in one process, holds the npz run's ``best.npz`` key
    for key, bit for bit. Returns the test accuracy that the ``predict``
    CLI on one card serves from the reddit run's ``best/``."""
    for engine, ck in (("reddit", "ckpt"), ("mag", "mag_ckpt")):
        part = f"{engine}_train_dir"
        for r, rank in enumerate((a, b)):
            if not (rank[part]["writes"] and all(rank[part]["writes"])):
                raise AssertionError(f"[9p] {part}: rank {r} writes "
                                     f"{rank[part]['writes']}")
            for key in ("history", "digest", "test_acc"):
                if rank[part][key] != rank[f"{engine}_train"][key]:
                    raise AssertionError(f"[9p] {part}: rank {r}'s {key} "
                                         f"is not the npz run's")
        d = os.path.join(PROC_DIR, f"{ck}_dir", "best")
        got, load_s = _timed(_load_directory, d)
        with np.load(os.path.join(PROC_DIR, ck, "best.npz")) as z:
            same = sorted(got) == sorted(z.files) and all(
                got[k].dtype == z[k].dtype and np.array_equal(got[k], z[k])
                for k in z.files)
        files = a[part]["ckpt_files"]
        print(f"[9p] {part}: best/ saved {len(a[part]['writes'])} times by "
              f"rank 0 and {len(b[part]['writes'])} by rank 1 (each save "
              f"entered by both); files (name, bytes) {files}; restored "
              f"here in {load_s} s, bit for bit the npz run's best.npz "
              f"{same}; history and parameters the npz run's on both ranks;"
              f" train_call_s {a[part]['train_call_s']} (npz "
              f"{a[f'{engine}_train']['train_call_s']})", flush=True)
        distcp = [f for f, _ in files if f.endswith(".distcp")]
        if not same or distcp != [f"__{r}_0.distcp"
                                  for r in range(PROC_RANKS)]:
            raise AssertionError(f"[9p] {part}: {d} ({files})")
    return _predict_ckpt(os.path.join(PROC_DIR, "ckpt_dir", "best"))


def run_process_mesh(mesh_steps: dict, reddit_acc: float,
                     mag_acc: float) -> dict:
    """Phase 9p: 2 ranks on the one card, each a process of its own with
    the gloo backend, run the reddit and MAG steps and trainers, D1 and the
    push over a mesh over processes; the parent checks what they print
    against phases 9 and 9b and each other, then predicts from their
    checkpoint on one card. Returns the launches by path, summed over the
    ranks."""
    shutil.rmtree(PROC_DIR, ignore_errors=True)
    os.makedirs(PROC_DIR)
    ports = f"{_free_port()},{_free_port()}"
    logs = [os.path.join(PROC_DIR, f"rank{r}.log") for r in range(PROC_RANKS)]
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [*RANK_COMMAND, "--rank", str(r), ports,
                 os.path.abspath(PROC_DIR)], cwd=here, stdout=f,
                stderr=subprocess.STDOUT))
    timed_out = False
    try:
        for p in procs:
            p.wait(timeout=max(t0 + PROC_TIMEOUT - time.time(), 1.0))
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.time() - t0
    for r, log in enumerate(logs):
        with open(log) as f:
            text = f.read()
        ok = procs[r].returncode == 0 and f"RANK{r} OK" in text
        shown = [ln for ln in text.splitlines() if ln.startswith("[9p]")]
        print("\n".join(f"[9p] rank {r}: {ln[5:]}" for ln in shown),
              flush=True)
        if timed_out or not ok:
            raise AssertionError(
                f"[9p] rank {r} exited {procs[r].returncode} (timed out "
                f"{timed_out}) after {wall} s:\n{text[-6000:]}")
    ranks = [_rank_parts(log) for log in logs]
    a, b = ranks
    for part in ("reddit_train", "mag_train"):
        if a[part]["digest"] != b[part]["digest"]:
            raise AssertionError(f"[9p] {part}: the ranks' parameters differ")
        if a[part]["history"] != b[part]["history"]:
            raise AssertionError(f"[9p] {part}: the ranks' histories differ")
    for run in a["d1"]["runs"]:
        if a["d1"]["runs"][run]["digest"] != b["d1"]["runs"][run]["digest"]:
            raise AssertionError(f"[9p] D1 {run}: the ranks' results differ")
    for (n_data, n_model), axis in PROC_D1_2D:
        for name, _, _ in PROC_D1[:2]:
            run = f"{name}_{n_data}x{n_model}_{axis}"
            ra, rb = a["d1"]["runs"][run], b["d1"]["runs"][run]
            print(f"[9p] D1 {name} along '{axis}' of a {n_data} x {n_model} "
                  f"mesh over the ranks: groups a rank {ra['groups']}; "
                  f"launches rank 0 {ra['launches']}, rank 1 "
                  f"{rb['launches']}; hops_s {ra['hops_s']}, {rb['hops_s']}"
                  f" (1-D: {a['d1']['runs'][name]['hops_s']}); transport "
                  f"calls {ra['transport']['calls']}, comm_s "
                  f"{ra['transport']['comm_s']}, stage_s "
                  f"{ra['transport']['stage_s']} (1-D: "
                  f"{a['d1']['runs'][name]['transport']['calls']} calls); "
                  f"max_rel_err {ra['max_rel_err']} (limit {ra['limit']}); "
                  f"bit for bit the 1-D run and across the ranks", flush=True)
    steps_per_rank = 11                   # _proc_tp_step's first and 10 timed
    for part, engine in (("reddit_tp", "dense"), ("mag_tp", "mag")):
        if a[part]["digest"] != b[part]["digest"]:
            raise AssertionError(f"[9p] {part}: the ranks' parameters differ")
        first = mesh_steps[f"{engine}_tp"]["first_loss"]
        if abs(a[part]["loss"] - first) > TOL * abs(first):
            raise AssertionError(f"[9p] {part}: loss {a[part]['loss']} "
                                 f"against {first} in the first step of "
                                 f"9t/9tb")
        want = ({"dropnode_mean": steps_per_rank, "adam": steps_per_rank}
                if engine == "dense" else
                {"adam": steps_per_rank, "embed_prop_fwd": steps_per_rank,
                 "embed_prop_bwd": steps_per_rank})
        for r, rank in enumerate(ranks):
            if rank[part]["launches"] != want:
                raise AssertionError(f"[9p] {part}: rank {r} launched "
                                     f"{rank[part]['launches']}, want {want}")
        if [a[part]["columns"], b[part]["columns"]] != [[0], [1]]:
            raise AssertionError(f"[9p] {part}: columns {a[part]['columns']}"
                                 f", {b[part]['columns']}")
    for part, ref in (("reddit_train", reddit_acc), ("mag_train", mag_acc)):
        got, n_test = a[part]["test_acc"], a[part]["n_test"]
        if abs(got - ref) > 1.0 / n_test + 1e-12:
            raise AssertionError(f"[9p] {part}: test_acc {got} against "
                                 f"{ref} on one process")
    for part in ("reddit_train", "mag_train"):
        if any(b[part]["writes"]) or not all(a[part]["writes"]):
            raise AssertionError(f"[9p] {part}: a rank other than 0 wrote "
                                 f"best.npz")
    served = _predict_ckpt(os.path.join(PROC_DIR, "ckpt", "best.npz"))
    rank_acc = a["reddit_train"]["test_acc"]
    if abs(served - rank_acc) > 1.0 / a["reddit_train"]["n_test"] + 1e-12:
        raise AssertionError(f"[9p] predict from the ranks' best.npz: "
                             f"test_acc {served}, the ranks' {rank_acc}")
    served_dir = _proc_directories(a, b)
    if served_dir != served:
        raise AssertionError(f"[9p] predict from the ranks' best/: test_acc "
                             f"{served_dir}, from best.npz {served}")
    for engine, part, tag in (("dense", "reddit_step", "9"),
                              ("mag", "mag_step", "9b")):
        one = mesh_steps[engine]
        print(f"[9p] {engine} step over {PROC_RANKS} ranks (synchronized "
              f"wall, ms): rank 0 {a[part]['step_ms']}, rank 1 "
              f"{b[part]['step_ms']}; the transport's share (gloo staging "
              f"+ collectives) {a[part]['transport_share']}, "
              f"{b[part]['transport_share']}; phase {tag}: one-process mesh "
              f"{one['mesh_step_ms']}, one card {one['one_card_step_ms']}; "
              f"first step against the one-process mesh: worst "
              f"{a[part]['worst']} {a[part]['max_rel_err']}, "
              f"{b[part]['max_rel_err']}", flush=True)
    for engine, part, tag in (("dense", "reddit_tp", "9t"),
                              ("mag", "mag_tp", "9tb")):
        one = mesh_steps[f"{engine}_tp"]
        print(f"[9p] {engine} step split over 'model' on a 1 x 2 mesh whose "
              f"model shards are the 2 ranks (synchronized wall, ms): rank 0 "
              f"{a[part]['step_ms']}, rank 1 {b[part]['step_ms']}; the "
              f"transport a step {a[part]['transport_a_step']}, share "
              f"{a[part]['transport_share']}, "
              f"{b[part]['transport_share']}; phase {tag}: "
              f"{one['step_ms']}; first step against the one-process 1 x 2 "
              f"mesh: worst {a[part]['worst']} {a[part]['max_rel_err']}, "
              f"{b[part]['max_rel_err']}; loss {a[part]['loss']} ({tag}'s "
              f"first {one['first_loss']}); replicas bit for bit "
              f"{a[part]['digest'] == b[part]['digest']}", flush=True)
    for part, ref, tag in (("reddit_train", reddit_acc, "9"),
                           ("mag_train", mag_acc, "9b")):
        print(f"[9p] {part}: test_acc {a[part]['test_acc']} (phase {tag}: "
              f"{ref}); launches rank 0 {a[part]['launches']}, rank 1 "
              f"{b[part]['launches']}; steps {a[part]['steps']}, "
              f"batch_time_median_s {a[part]['batch_time_median_s']}, "
              f"{b[part]['batch_time_median_s']}; train_call_s "
              f"{a[part]['train_call_s']}, {b[part]['train_call_s']}; "
              f"best.npz written by rank 0 {sum(a[part]['writes'])} times, "
              f"by rank 1 {sum(b[part]['writes'])}", flush=True)
    print(f"[9p] predict on one card from the ranks' best.npz: test_acc "
          f"{served}, the ranks' {rank_acc} (equal: {served == rank_acc}); "
          f"D1 default threshold {a['d1']['default_threshold']} -> "
          f"{a['d1']['default_propagator']} (compression "
          f"{a['d1']['compression']}); push {a['push']}; the nccl refusal: "
          f"{a['nccl_refusal']['message']!r}; gloo on card tensors: "
          f"{a['gloo_cuda']['coverage']}; phase wall {wall} s", flush=True)
    launches = {}
    for part in ("reddit_train", "mag_train", "reddit_tp", "mag_tp",
                 "reddit_train_dir", "mag_train_dir"):
        launches[part] = {k: a[part]["launches"].get(k, 0)
                          + b[part]["launches"].get(k, 0)
                          for k in COUNTED}
    for run in a["d1"]["runs"]:
        launches[f"d1_{run}"] = {
            k: a["d1"]["runs"][run]["launches"].get(k, 0)
            + b["d1"]["runs"][run]["launches"].get(k, 0) for k in COUNTED}
    return {"launches": launches, "wall_s": wall, "ranks": ranks,
            "predict_test_acc": served}


def main() -> int:
    t_start = time.time()

    def mark(label: str) -> None:
        print(f"[time] {label} done at {time.time() - t_start:.3f} s",
              flush=True)

    phase_device()
    phase_build()
    mark("build")
    t0 = time.time()
    data = load_data(DATASET, split_seed=preset("reddit").seed1)
    print(f"[data] {DATASET} generated in {time.time() - t0:.3f} s",
          flush=True)
    k1, k2 = check_k1(K1_SHAPE, shards=DENSE_SHARDS), check_k2(data)
    mark("3 (K1, K2)")
    adam = check_adam()
    mark("3a")
    push_reddit = check_push(data, preset("reddit").replace(dataset=DATASET),
                             "3e", ("jax", "bucket"))
    mark("3e")
    push_sharded = check_sharded_push(
        data, preset("reddit").replace(dataset=DATASET), push_reddit)
    mark("3i")
    push_2d = check_sharded_push_2d(
        data, preset("reddit").replace(dataset=DATASET), push_reddit)
    mark("3m")
    hub = check_hub_graph()
    mark("3j")
    push_hub = check_hub_push()
    mark("3k")
    small = preset("reddit").replace(dataset=SMALL, epochs=3,
                                     unlabel_num=500, dropnode_rate=0.0)
    check_small_reference(small)
    mark("4")
    check_small_reference(small.replace(push_backend="bucket"))
    mark("4d")
    launches, r_main = run_main_path(data)
    mark("5")
    long_run = run_long_run(data, r_main)
    long_launches = long_run["launches"]
    mark("5g")
    long_dir_launches = run_long_run_dir(data, long_run)
    mark("5g-dir")
    scan = {"reddit": run_scan_pair("reddit", data)}
    scan["reddit"]["group"] = check_group("dense", data)
    mark("5h")
    profile_path(preset("reddit").replace(dataset=DATASET, epochs=2), data,
                 "profile")
    mark("6")
    mesh_steps = {"dense": check_mesh_step("dense", data)}
    r_mesh, mesh_launches = run_mesh_path(
        preset("reddit").replace(dataset=DATASET, epochs=2), data,
        DENSE_SHARDS, "9")
    print(f"[9] test_acc on {DENSE_SHARDS} shards {r_mesh.test_acc}, on one "
          f"card (5) {r_main.test_acc}; train_call total_s "
          f"{r_mesh.total_time} against {r_main.total_time}", flush=True)
    mark("9")
    mesh_steps["dense_tp"] = check_tp_step("dense", data)
    mark("9t")
    del data

    t0 = time.time()
    mag = load_data(MAG_DATASET, split_seed=preset("mag_scholar_c").seed1)
    print(f"[data] {MAG_DATASET} generated in {time.time() - t0:.3f} s",
          flush=True)
    mag_padded = PaddedFeatures.from_csr(mag.features)
    k3 = check_k3(mag_padded)
    check_k2_mag(mag, k2)
    mark("3c")
    k3_window = check_k3_window(mag_padded)
    mark("3h")
    check_small_reference(preset("mag_scholar_c").replace(
        dataset=MAG_SMALL, epochs=3, dropnode_rate=0.0, input_droprate=0.0,
        hidden_droprate=0.0))
    mark("4b")
    mag_launches = run_mag_path(mag)
    mark("5b")
    mag_ckpt_launches = run_mag_checkpoints(mag)
    mark("5i")
    scan["mag"] = run_scan_pair("mag", mag)
    scan["mag"]["group"] = check_group("mag", mag, mag_padded)
    mark("5h (MAG)")
    profile_path(preset("mag_scholar_c").replace(dataset=MAG_DATASET,
                                                 epochs=5), mag, "profile-mag")
    mark("6b")
    mesh_steps["mag"] = check_mesh_step("mag", mag, mag_padded)
    r_mag_mesh, mag_mesh_launches = run_mesh_path(
        preset("mag_scholar_c").replace(dataset=MAG_DATASET, epochs=5), mag,
        MAG_SHARDS, "9b")
    table = r_mag_mesh.model.gathered_table()
    vocab = r_mag_mesh.model.cfg.num_features
    if table[vocab:].any():
        raise AssertionError("[9b] a padding row of the table moved")
    print(f"[9b] the gathered table [{table.shape[0]},{table.shape[1]}]: "
          f"{table.shape[0] - vocab} padding rows, all zero; peak device "
          f"memory {PEAK_GB['9b']} GB on {MAG_SHARDS} shards of the card "
          f"against {PEAK_GB['mag']} GB on one (5b); test_acc "
          f"{r_mag_mesh.test_acc}", flush=True)
    mag_mesh_acc = r_mag_mesh.test_acc
    del table, r_mag_mesh
    mark("9b")
    mesh_steps["mag_tp"] = check_tp_step("mag", mag, mag_padded)
    del mag_padded
    mark("9tb")
    del mag
    torch.cuda.empty_cache()
    proc = run_process_mesh(mesh_steps, r_mesh.test_acc, mag_mesh_acc)
    mark("9p")

    amazon_cfg = preset("Amazon2M").replace(dataset=AMAZON, epochs=2,
                                            predict_precision="auto")
    t0 = time.time()
    amazon = load_data(AMAZON, split_seed=amazon_cfg.seed1)
    print(f"[data] {AMAZON} generated in {time.time() - t0:.3f} s",
          flush=True)
    # one build of the 2M-node operators for phases 3d and 7
    ops = amazon_operators(amazon)
    mark("Amazon2M data and operators")
    k1_amazon = check_k1(AMAZON_K1_SHAPE, ops["x"], "K1 Amazon2M")
    for key in ("max_abs_err", "max_rel_err"):
        k1[key] = max(k1[key], k1_amazon[key])
    k1["amazon"] = {k: v for k, v in k1_amazon.items()
                    if k not in ("name", "route", "source", "replaces")}
    fast = check_fast_kernels(ops, k2)
    mark("3d")
    sweep_launches = precision_sweep(ops)
    mark("7")
    seg = check_segment(ops)
    seg_bf16 = check_segment_bf16(ops, seg)
    mark("3g")
    d1 = check_d1(ops)
    mark("8")
    d1_2d = check_d1_2d(ops, d1)
    mark("8m")
    del ops
    torch.cuda.empty_cache()
    push_amazon = check_push(amazon, amazon_cfg, "3f", ("bucket",))
    mark("3f")
    check_small_fast()
    check_small_reference(amazon_cfg.replace(
        dataset=AMAZON_SMALL, epochs=3, dropnode_rate=0.0))
    mark("4c")
    r_native, amazon_launches = run_amazon_path(amazon, "auto", "amazon")
    mark("5c")
    profile_path(amazon_cfg, amazon, "profile-amazon")
    mark("6c")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    r_bucket, bucket_launches = run_amazon_path(amazon, "bucket",
                                                "amazon-bucket", CKPT_DIR)
    print(f"[amazon-bucket] preprocess_s {r_bucket.preprocess_time} with the "
          f"bucket push on the card against {r_native.preprocess_time} with "
          f"native (5c); test_acc {r_bucket.test_acc} (5c: "
          f"{r_native.test_acc}; anchor 0.996, not gated)", flush=True)
    mark("5d")
    serve = run_serving(r_bucket, amazon, os.path.join(CKPT_DIR, "best.npz"))
    mark("5e")
    files = run_serving_files(amazon)
    mark("5f")
    del amazon

    k1["launches_by_path"] = {
        "reddit": launches["dropnode_mean"],
        "reddit_resumed": long_launches["dropnode_mean"],
        "reddit_mesh": mesh_launches["dropnode_mean"],
        "reddit_tp": mesh_steps["dense_tp"]["launches"]["dropnode_mean"],
        "amazon": amazon_launches["dropnode_mean"],
        "amazon_bucket": bucket_launches["dropnode_mean"],
        "files_train": files["train"]["launches"]["dropnode_mean"]}
    p1 = push_reddit["launches"]["jax"]
    k2["launches_by_path"] = {
        "reddit": launches["csr_spmm_prop"],
        "reddit_resumed": long_launches["csr_spmm_prop"],
        "mag": mag_launches["csr_spmm_prop"],
        "amazon": amazon_launches["csr_spmm_prop"],
        "sweep": sweep_launches["csr_spmm_prop"],
        "p1_reddit": p1["csr_spmm_prop"],
        "d1_all_gather_f32": d1["launches"]["all_gather_f32"][
            "csr_spmm_prop"],
        "serve_f32": serve["f32"]["launches"]["csr_spmm_prop"],
        "files_predict_f32": files["f32"]["launches"]["csr_spmm_prop"],
        "p1_sharded_reddit": push_sharded["launches"]["csr_spmm_prop"],
        "d1_reddit_mesh": mesh_launches["csr_spmm_prop"],
        "d1_mag_mesh": mag_mesh_launches["csr_spmm_prop"]}
    k2["launches_by_path"]["hub"] = hub["launches"]["csr_spmm_prop"]
    k2["hub"] = {k: v for k, v in hub.items()
                 if k not in ("launches", "int8")}
    k2["p1_over_at"] = {k: v for k, v in push_reddit["jax"]["times"][
        "k2_over_at"].items() if k != "bytes"}
    adam["launches_by_path"] = {
        path: counts["adam"] for path, counts in (
            ("reddit", launches), ("reddit_resumed", long_launches),
            ("reddit_mesh", mesh_launches),
            ("reddit_tp", mesh_steps["dense_tp"]["launches"]),
            ("mag", mag_launches), ("mag_mesh", mag_mesh_launches),
            ("mag_tp", mesh_steps["mag_tp"]["launches"]),
            ("amazon", amazon_launches), ("amazon_bucket", bucket_launches),
            ("files_train", files["train"]["launches"])) if counts["adam"]}
    for k in (k1, k2):
        k["launches"] = sum(k["launches_by_path"].values())
    for k in k3 + k3_window:
        k["launches_by_path"] = {"mag": mag_launches[k["name"]],
                                 "mag_mesh": mag_mesh_launches[k["name"]]}
        if mesh_steps["mag_tp"]["launches"].get(k["name"]):
            k["launches_by_path"]["mag_tp"] = mesh_steps["mag_tp"][
                "launches"][k["name"]]
        k["launches"] = sum(k["launches_by_path"].values())
    for k in fast:
        if k["name"] == "csr_spmm_prop_bf16":
            k["hub"] = {"ms": hub["ms"]["split_bf16"],
                        "unsplit_ms": hub["ms"]["unsplit_bf16"],
                        "hop": {f: hub["hop"][f] for f in (
                            "csr_spmm_prop_bf16", "csr_spmm_prop_bf16_carry")},
                        "run": hub["run"]["bf16"]}
        if k["name"] in hub["int8"]:
            k["hub"] = {**hub["int8"][k["name"]], "hop": {
                f: e for f, e in hub["hop"].items()
                if f.rsplit("_", 1)[0] == k["name"]}}
        if k["name"] in ("csr_spmm_q8", "csr_spmm_q8mxu"):
            k["hub"]["run"] = hub["run"][
                "int8cast" if k["name"] == "csr_spmm_q8" else "int8"]
            k["split"] = ("hub rows split by the operator's SplitPlan "
                          "(3j; 5f for K2-q8mxu)")
        if k["name"] == "csr_spmm_q8mxu":
            k["files"] = files["propagation"]["q8mxu_split"]
        if k["name"] == "quantize_with_amax":
            k["shard"] = {"shape": d1["shape"],
                          **d1["times"]["quantize_with_amax"]}
        k["launches_by_path"] = {
            "amazon": amazon_launches[k["name"]],
            "amazon_bucket": bucket_launches[k["name"]],
            "sweep": sweep_launches[k["name"]],
            "serve_auto": serve["auto"]["launches"][k["name"]],
            "files_train": files["train"]["launches"][k["name"]],
            **{f"files_predict_{p}": files[p]["launches"][k["name"]]
               for p in ("int8", "auto")},
            "hub": hub["launches"][k["name"]],
            **{f"d1_{run}": la[k["name"]]
               for run, la in d1["launches"].items() if la[k["name"]]}}
        k["launches"] = sum(k["launches_by_path"].values())
    pushes = push_entries(push_reddit, push_amazon, push_hub,
                          bucket_launches, push_sharded)
    seg_bf16["hub"] = hub["segment"].pop("bf16_carry")
    seg["hub"] = hub["segment"]
    served = serving_entries(seg, d1, serve)
    served.insert(1, seg_bf16)
    # 9p's launches, summed over its ranks; 8m's and 3m's on the 2-D mesh
    paths = {f"process_mesh_{path}": counts
             for path, counts in proc["launches"].items()}
    paths.update({f"d1_2d_{run}": la
                  for run, la in d1_2d["launches"].items()})
    paths.update({f"p1_sharded_2d_{axis}": r["launches"]
                  for axis, r in push_2d.items()})
    # the directory checkpoints' paths: 5g's resume, 5i, 5e's predict
    paths.update({"reddit_resumed_dir": long_dir_launches,
                  "mag_latest_dir": mag_ckpt_launches,
                  "serve_f32_dir": serve["f32_dir"]["launches"]})
    # 5h's runs, per step and with scan_steps (graph replays)
    for name, sc in scan.items():
        per, rolled = sc.pop("launches")
        paths[f"{name}_10_epochs"], paths[f"{name}_scan_steps"] = per, rolled
    for k in (k1, k2, adam, *fast, *k3, *k3_window, *pushes, *served):
        for path, counts in paths.items():
            if counts.get(k["name"], 0):
                k["launches_by_path"][path] = counts[k["name"]]
        k["launches"] = sum(k["launches_by_path"].values())
    print(json.dumps({"serving": serve, "serving_files": files, "d1": {
        k: d1[k] for k in ("err", "wall_s", "compression")}, "d1_2d": {
        k: d1_2d[k] for k in ("err", "wall_s", "held_GB")},
        "push_2d": push_2d,
        "mesh_steps": mesh_steps, "scan_steps": scan,
        "peak_gb": PEAK_GB, "process_mesh": {
            k: proc[k] for k in ("wall_s", "predict_test_acc")}}))
    print(json.dumps({"kernels": [k1, k2, adam, *fast, *k3, *k3_window,
                                  *pushes, *served]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2:]))
    sys.exit(main())
