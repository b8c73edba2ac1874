#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``xrt_tpu_torch/csrc`` with ``nvcc`` (one
process per source, in parallel), then runs thirty-eight phases and exits
non-zero if any fails:

1. card and build: the card's name and power limit, torch and CUDA
   versions, the build time, the registers and spills of the forward
   Kirchhoff, adjoint, histogram and toroid search kernels;
2. kernels against their plain PyTorch versions on the card: kernel B1
   (recentred; mono, narrowband, poly, every ``accumulate`` value) and B2
   (per-pair double-float; 'fast', 'exact') at 8192 x 16384 pairs to
   max|d| / max|ref| < 2e-5 (f32 sums of ~1e4 terms taken in another
   order), and the double-float device helpers bit for bit (also on
   products spanning positions of 1e-6 to 1e5 mm, their squares and
   kappa x r to ~1e13, where two_prod's FMA must give the Dekker bits),
   and sincosf against sinf / cosf bit for bit (B2 'exact' uses it); the
   histogram kernel B4 (``hist2d_kernel``) for k = 1 and 3 against its
   plain version with the sums taken in float64: 1e7 uniform rays into
   128 x 128 (a private copy of the table in every CTA's shared memory) and
   into 1024 x 1024 (device memory), the 1D case, a focused beam (95% of
   the rays in four bins), rays on edges / NaN / +-inf / outside
   (identical non-empty bins) and a ray count that is no multiple of the
   block, to max|h - h64| / max|h64| < 1e-5 (1e-4 for the focused beam),
   two launches bit-identical; both routes bit-identical on one input;
   NaN and +-inf weights as ``index_add_`` gives them; float64 to 1e-12;
   and a plot's eight histograms in one launch (``hist_plot``) at 128 and
   1024 bins, uniform, focused and special rays, each histogram and the
   total against ``hist_plot_plain`` with float64 sums to the same limits,
   two launches and both routes bit-identical, float64 to 1e-12;
3. the main path: the Gaussian -> slit -> toroid -> 256 x 256 screen
   WaveChain at 2e5 samples per wave in float32 (4.0e10 + 1.3e10 pairs),
   with the per-hop stage times, the chain time (median of 3 after a
   warm-up), pairs/s and the kernel launches of that run;
4. cross-checks: the chain at 2e4 samples on a 64 x 64 screen in float32
   (kernels) against float64 (plain path) to max|dI| / max I < 5e-3, and
   the full-size toroid -> screen hop with the B2 kernel ('fast',
   'exact') against the recentred result to < 5e-3;
5. the ``kernels`` line: every kernel with its launches, time, plain
   version's time, bound and (B4, B4-bwd) the library call's time at the
   main-path shapes (``hist_plot`` has no library call; beside it the time
   of the step it replaces, colorize and eight ``hist2d_kernel``
   launches); for B1, B2 and B3 also the share of their second
   kernel (the sum of the partials), their scratch and their registers
   and spills from the build log (``-Xptxas -v``).  The adjoint kernels
   are held against the plain blocked backward there too, on the slices
   it can do in seconds (it
   takes 1.6 ns a pair): the destination rows of the last 8192
   destinations against all sources, the source rows of the last 2048
   sources against all destinations, and, from a second launch at the same
   shape with the cotangents of all other destinations set to zero, every
   source row and the scalars of those 8192 destinations (the rows of the
   other destinations must then be exact zeros); the line ends with the
   rows of B2 'fast' and B1 mono at a SoftiMAX tile pair's shape (phase
   13), with their launches on the SoftiMAX main path;
6. the trace main path: GeometricSource -> Si toroid -> screen at 1e7
   rays per pass in float32 through ``run_ray_tracing`` (one plot of
   128-bin axes, auto limits, 4 repeats, a CUDA generator), with the
   calibration time, the time per pass (median of 3 runs after a
   warm-up), rays/s, the split of one pass by CUDA events (the histogram
   step split into the ``_plot_arrays`` glue and ``hist_plot``) and the
   histogram launches (exactly one ``hist_plot`` per pass); then the same
   with a 1024 x 1024 plot at 1 repeat, whose 2D colour columns go to
   device memory;
7. the trace cross-check: one pass at 2e5 rays in float32 against float64
   from the same float64 samples: transmitted fraction to 1e-4, weighted
   centroids to 1e-3 of the image size and sizes to 1e-3.

8. adjoint kernels against their plain versions: B3 (the backward of B1
   and B2: recentred mono, narrowband, poly; per-pair double-float 'fast',
   'exact') at 8192 x 16384 with random output cotangents against the
   plain blocked backward (autograd through the plain forward,
   checkpointed), every destination-key row, source-key row and scalar's
   cotangent to 1e-4 of its largest magnitude (f32 sums in another order;
   the kernels differentiate the sincos polynomials as (2 pi cos,
   -2 pi sin), the plain version the polynomials themselves, 1.3e-5 a
   pair, which a sum of few terms does not average down), and two
   launches on the same inputs bit-identical; B4's backward (the gather)
   against advanced indexing, exactly equal, for k = 1 and 3, 128 x 128
   and 1024 x 1024, 1D, special values, 1 to 7 rays, views at a 4-byte
   offset and float64;
9. the gradient main path: value and gradient of a Gaussian-weighted focal
   flux of the phase-3 chain (2e5 samples per wave, 256 x 256 screen,
   float32) with respect to the source waist (field cotangents), the
   toroid's pitch offset (linearized retargeting of its receiving samples
   and of the screen's samples in its frame, and ``reflect_wave`` with the
   tensor pitch: destination-position cotangents) and the amplitude of a
   height offset of its surface samples with a fixed parabolic profile
   along the mirror (source-position cotangents; a rigid offset is a
   piston phase, which no intensity sees): forward +
   backward time (median of 3), the forward alone, the launches (B1 x 2
   and B3 x 2 per step) and peak memory; the three gradients are held to
   those of one more step whose backward runs the plain blocked backward
   in place of the adjoint kernels (about 90 s of the run);
10. the gradient cross-check: the same at 2e4 samples on a 64 x 64 screen,
    float32 kernels against the float64 plain path (each parameter within
    3e-2) and float64 autograd against a central finite difference
    (within 1e-3);
11. the B2-path gradient: the full-size toroid -> screen hop with
    ``phase_mode`` 'fast' and 'exact' against the recentred gradient of
    the same loss (within 3e-2), with the launches;
12. the trace gradient: d(weighted central flux) / d(pitch) through
    GeometricSource -> toroid (with the search) -> screen -> ``hist2d``
    (B4 forward and backward) at 1e7 rays in float32, with times, peak
    memory and launches; the same through the three-column histogram of a
    colour plot (weights Jss, Jpp and their sum: twice the flux, so twice
    the gradient), at 128 x 128 and at 1024 x 1024 bins; and at 2e5 rays
    float32 against float64 and a finite difference (rtol 0.1).

13. the SoftiMAX main path (``tools/torch_bench_softimax.py``, xrt's
    speed test 3): undulator -> FE slit -> M1 -> M2 -> blazed grating ->
    M3 -> exit slit -> M4 -> M5 (parametric ellipses) -> three 64 x 64
    focal images at 2e5 samples per wave, float32, tiled (M1 -> M2 and
    M2 -> PG by 5 x 10 tile pairs, the contact pairs on B2): the build
    time, each stage's mode, tile pairs per mode and time, the undulator
    field's time, the chain time (median of 3 after a run whose launches
    are counted: B2 once per contact pair, B1 for every other pair and
    stage), pairs/s over 7 N^2 + 3 N 64^2, the focal images' totals and
    peaks (finite and positive) and the peak memory; then the first
    contact tile pair of M2 -> PG through B2, and the first recentred one
    through B1, against their plain versions (< 2e-5);
14. the SoftiMAX cross-checks: the undulator field at 2e5 samples in
    float32 against float64 on the same samples (amplitude to 1e-3,
    overlap > 0.999); the M1 -> M2 stage at 2e4 samples tiled against
    untiled (max|dEs| / max|Es| <= 0.02); the chain fed at every hop with
    xrt's receiver samples (``tests/golden/ref_softimax.npz``, read with
    numpy; the phase fails if the file is missing), float32 against
    float64, overlap above the reference package's own floors at every hop
    (0.999 up to the grating, pg 0.7, m3 / es / m4 / m5 0.6, focus 0.55);
38. (run after phase 14) the Kirchhoff stages' preparation kernel
    (``csrc/kirchhoff_prep.cu``) at the SoftiMAX chain's shapes (a 4e4 x
    2e4 recentred and a 'fast' tile pair, the 2e5 x 2e5 stage PG -> M3):
    its device time by torch.profiler against its bytes bound and the
    plain preparation's, the host's time a call, its keys and a whole
    call's sums against the plain preparation's (the same bits), one
    ``prep:<mode>`` launch a call;
15. xrt's speed test 1 (``tools/torch_bench_analyzer.py``), nothing cut:
    a diced Johansson Si(444) analyzer traced from three geometric
    sources, 96 steps x 1e5 rays each, float32, each step filling xrt's
    three histograms through ``hist2d_kernel`` (400 x 400 and two
    128 x 128; 864 launches): the time, rays/s, the time per source and
    the accumulated flux, with xrt's published i7 times as context; one
    step of each source split by CUDA events (source, reflect, the
    generic bracket + search alone with its Illinois iterations, expose, the
    histograms and their share of the step); the three histograms of a
    step against ``hist2d_plain`` with float64 sums (< 1e-5, the same
    non-empty bins);
37. (run after phase 15) the toroid crystals' search kernel
    (``csrc/toroid_search.cu``, ``oes/toroid_search.py``) on speed test
    1's analyzer: 1e7 float32 and 1e6 float64 rays of its flat source
    against the generic ``find_intersection_dz`` (t off by more than 4 ulp
    / 1e-9 mm on at most 1e-4 of the rays, ``lost`` identical), the
    kernel's time against its bytes and instruction bounds and the
    generic search's, ``reflect`` through the kernel and through the
    generic search (one launch / none; s and p flux within 1e-5), and the
    gradient case at 1e5 float64 rays (t0 from the kernel, the Newton
    steps on the tape: t and dt/dh of a height offset to 1e-9);
16. the DCM trace: GeometricSource -> Si(111) DCM (30 m, fixed exit
    20 mm, the golden's Bragg angle) -> screen, +-8 eV, 1e7 rays a pass,
    float32, 4 passes through ``run_ray_tracing`` with one energy-coloured
    plot (one ``hist_plot`` a pass): pass time (median of 3 runs after a
    warm-up), rays/s, the split of a pass; the flux per ray, weighted
    mean and spread of the energy over the last run's 4e7 rays against
    ``tests/golden/ref_trace_dcm.npz`` at its test's limits (2%, 0.05 eV,
    3%; read with numpy, the phase fails if the file is missing);
    ``hist_plot`` against ``hist_plot_plain`` on one pass (< 1e-5); and
    float32 against float64 on the same 2e5 rays (flux and spread 2e-3,
    mean 0.01 eV);
17. BASELINE configuration 4 as ``examples/02_undulator_dcm_kb.py`` builds
    it with ``BeamLine.place``: undulator (gNodes 64; 4e6 candidates
    through the far-field integral a pass) -> Si(111) DCM -> elliptical
    KB pair -> focus, 1e6 rays a pass, float32, 2 passes through
    ``run_ray_tracing``: the pass time and the undulator ``shine``'s part
    (CUDA events), the focal sizes (std of the rays above 1e-3 of the
    peak) under 20 um in both planes, and how far the resampling's
    float32 cumulative sum over the 4e6 candidates ends from 1.

18. BASELINE configuration 5's coherent modes, float32, at full width:
    256 undulator filaments of 1e5 slit samples (the first through
    ``slit.propagate_wave`` from the source, the others ``shine_wave`` on
    its samples; their time and kernel launches a filament by
    torch.profiler), ``solve_modes`` to 8 modes (weights summing to 1,
    w0 > 0.25, w0 > 1.2 w1), and each mode slit -> Au zone plate (2e5
    samples, ``diffract``, the zone mask) -> 256 x 256 focal grid over
    +-0.2 rN (``Screen.expose_wave``), 3.3e10 pairs a mode: the times of
    each hop (CUDA events), pairs/s, peak memory, exactly 16 B1 launches,
    each held against the plain version on its last 2048 destinations
    (< 2e-5); the zone mask's open fraction (0.2-0.8, float32 against
    float64 on the same samples to 1e-3), the focal concentration (the
    centre > 5 x the outer mean), the slit stack's degree of transverse
    coherence equal to the sum of the squared weights (1e-4); the
    coherence analysis of the focal stack (DoTC, PCA modes, coherent
    fractions along x and z, the degree-of-coherence map); and the whole
    path at 32 filaments, 2e4 / 2e4 samples and a 64 x 64 focus, float32
    against float64 (the 8 largest weights to 1e-3, the focal intensity
    to max|dI| / max I < 5e-3);
19. BASELINE configuration 2: bending magnet -> Rh toroid + slit ->
    screen at 1e7 rays a pass (2e7 bending-magnet candidates), float32, 4
    passes through ``run_ray_tracing`` (one ``hist_plot`` a pass, held
    against its plain version): pass time, rays/s, the footprint of each
    pass (std x < 0.3 mm, z < 0.1 mm), the split of a pass (the shine and
    its candidates through ``build_I_map``, the toroid's search, the slit,
    expose, histograms); float32 against float64 on the same 2e5 rays
    (flux per ray and weighted moments to 1e-3); the bending magnet's and
    the wiggler's ``build_I_map`` on ``tests/golden/ref_sources.npz``'s
    693 points (read with numpy; the file must be in the tree): float64 at
    the golden's tolerances (rtol 3e-8), float32 against float64 to 1e-5
    with no NaN; a 1e6-ray wiggler shine, timed;
20. the field maps: the undulator's ``intensities_on_mesh`` on its auto
    meshes (65 x 33 x 33) with 36 energy-spread samples (2.5e6 points
    through the 64-node integral), Stokes and vortex, its
    ``multi_electron_stack`` and the bending magnet's Stokes map, timed;
    s0 float32 against float64 to 1e-5 for both sources.

21. bent crystals and Laue optics: (a) ``examples/04_bent_crystal_tt.py``,
    Si(111) 0.1 mm at 9 keV, Rm inf / 5 / 2 / 1 m over 201 angles, 4000
    Lawson steps, float32 and float64 timed, float32 against float64 (<
    5e-2 of the peak), the launches of one ``tt_amplitudes`` call (by
    torch.profiler at 50 and 100 steps); float64 against pyTTE's curves
    in ``tests/golden/ref_tt.npz`` (read with numpy; the file must be in
    the tree) at ``tests/test_tt.py``'s limits (Bragg 1e-4, Laue 1e-2 at
    8000 steps; cylindrical, spherical, anticlastic; sigma and pi); the
    gradient of the integrated reflectivity with respect to 1/R (1500
    steps) by autograd against a central difference (2%); (b) the
    bent-Laue monochromator of ``examples/13_laue_mono.py`` (Si(111) 0.7
    mm, R = 2 m, useTT, 60 keV +- 600 eV) at 1e6 rays a pass, float32, 4
    passes through ``run_ray_tracing``: pass time, nGood, flux, dE, the
    split of a pass (source, search, TT amplitudes, expose, histograms),
    ``hist_plot`` against its plain version (< 1e-5, the same non-empty,
    NaN and infinite bins), float32 against float64 on 2e5 rays (flux per
    ray within 1.9e-2 and weighted mean energy within 4.2 eV, about twice
    the card's reading; the reference package's own float32 error on the
    CPU, 8.64e-2 and 82 eV, is printed beside them); (c) ``BentLaue2D`` with
    volumetric diffraction at ``tests/test_bentlaue2d.py``'s geometry, 1e6
    rays, one reflect timed, its flux above a flat ``LauePlate``'s;
22. the CRL of ``examples/14_lenses_crl.py`` (Be, focus 0.1 mm, zmax 1 mm,
    t 0.05 mm, nCRL for f = 3 m at 9 keV, at 10 m; a flat 0.5 x 0.5 mm
    parallel beam) at 1e6 rays a pass, float32, 4 passes: the lens count,
    the focal distance (within 5% of the thin lens's), the focal sizes (<
    20 um), the transmission, the pass time and a lens's, the searches and
    host reads of a pass, the device's busy share of a pass
    (torch.profiler), ``hist_plot`` against its plain version (as in 21);
    a C plate's transmission against T_fresnel^2 e^(-mu t) (1e-3); float32
    against float64 on 2e5 rays (focal distance, sizes, transmission;
    printed);
23. the [W/Si]x40 multilayer mirror of ``examples/10_multilayer.py`` at
    the peak of its Parratt reflectivity, 1e6 rays a pass, float32, 4
    passes: pass time, the split of a pass, the traced reflectivity
    against the material's own at the rays' angles (1e-3),
    ``get_amplitude``'s time and launches a call, ``hist_plot`` against its
    plain version (as in 21), the peak reflectivity float32 against
    float64 (1e-3);
24. the Si powder rings of ``examples/15_xrd_powder.py`` (reflexes up to
    333, Cu K-alpha, a flat detector 150 mm behind) at 1e6 rays a pass,
    float32, 4 passes: pass time, the split of a pass with
    ``reflect_multi_hkl``'s time, the weighted radii of the 111, 220 and
    311 rings against Bragg's law (1%), ``hist_plot`` against its plain
    version (as in 21: the weights span twelve decades, and the kernels'
    fine words keep the bins that only faint rays fill);
25. the figure errors of ``examples/11_warping.py`` (a 30 nm, 80 mm
    waviness, a 20 nm rms random roughness, a 30 nm Gaussian bump) on its
    Rh toroid, each at 1e6 rays a pass, float32, 4 passes: pass time, the
    split of a pass with the map's heights and normals, the meridional
    angle the error adds to each ray against twice the normal's turn
    that its slopes give at the rays' points (15%), ``hist_plot`` against
    its plain version (as in 21); ``tests/test_figure_error.py:63``'s
    flat mirror with a 50 nm, 20 mm waviness (the added spread within 15%
    of twice the rms slope); float32 against float64 on 2e5 rays (flux
    per ray 3e-2, ROADMAP C3; added spread 1e-2);
26. a figure error on the wave chain, with its gradient:
    ``examples/16_parametric_optimization.py`` part 2's branch (slit ->
    Au toroid M1 -> flat M2 carrying a 1 nm, 4 mm waviness -> 129 x 129
    screen, 280 eV) at 2e5 samples on the slit and on each mirror,
    float32: the Gaussian-weighted focal flux and its gradient in the
    waviness amplitude (at the example's 12 nm) and M2's pitch (B1 three
    launches, B3 two a step),
    forward and forward + backward times, peak memory; the same step with
    the plain blocked backward in place of B3 (gradients within 1e-5); at
    the example's sizes (20000 slit samples, 48 x 64 a mirror) float32
    against float64 (3e-2) and float64 against four-point differences
    (1e-3);
27. the ellipsoidal capillary of ``examples/09_capillary.py`` with
    ``multiple_reflect`` (up to 8 bounces) on an annulus source of 3 mrad
    divergence 10 mm before it, 1e6 rays a pass, float32, 4 passes: pass
    time, the split with the searches and host reads, the bounce counts,
    the largest J of a good ray (1 + 1e-6), ``hist_plot`` against its
    plain version (as in 21), the bounce counts float32 against float64
    (5e-3 of the rays); one reflect of 1e6 rays off a parabolic mirror
    (collimation: angle std < 1e-7, mean 2 pitch within 1e-3), a
    hyperbolic mirror (virtual focus within 2%) and a DualVFM stripe
    (sags within 1%, a sagittal focus), float32 and float64;
28. the STL mesh mirror of ``examples/17_stl_mesh.py`` (the script writes
    the cylinder's STL into a temporary directory), 'quad' and 'spline',
    1e6 rays a pass, float32, 4 passes: host build time, pass time and
    split, the focus (z std < 0.1 x the unfocused beam,
    ``tests/test_mesh_oe.py``), the quad fit's meridional radius (1%),
    ``hist_plot`` against its plain version (as in 21), float32 against
    float64 (image centroid 1e-3 mm, size 1e-2);
29. the TXM volume of ``examples/18_txm.py`` (40^3 voxels, water with a
    gold cross, built with ``indexGrid=``) on a 50 um plate, 1e6 rays a
    pass, float32, 4 passes: pass time, the split with the chord
    integrals' time and the launches of a ``double_refract``, the gold
    cross's shadow, ``hist_plot`` against its plain version (as in 21);
    a uniform water grid against the plain water plate (1e-3), float32
    against float64 (1e-4).

30. BASELINE configuration 3 as named: ``tests/test_baseline_configs.py``'s
    undulator (gNodes 64) in the near field at the DCM's 30 m (111
    periods of the integral) -> Si(111) DCM -> screen, 1e5 rays a pass
    (at 2e5 a pass took 5.1 s), float32, 4 passes through
    ``run_ray_tracing``; its far-field twin on
    the same draws (4 passes) and the tapered source (taper (1.09, 11), 2
    passes): pass times, rays/s, the integral's time (CUDA events), the
    kernel launches of a ``build_I_map`` call of one ray block
    (torch.profiler), the device's busy share (near field), the
    transmitted band, ``hist_plot`` against its plain version (as in 21);
    in float64 at 2e4 rays the reference test's limits (band < 10 eV, the fixed
    exit parallel to 1e-9); float32 against float64 on the same draws
    (flux per ray 1e-3 and mean energy 0.01 eV on the rays both resample
    alike, the near-field map 1e-3 of its peak); the taper and near-field
    maps of ``tests/golden/ref_undulator.npz`` in float64 at
    ``tests/test_undulator.py``'s limits (read with numpy; the file must
    be in the tree);
31. the quadrature search (``gNodes=None``) on
    ``examples/02_undulator_dcm_kb.py``'s undulator: the node count, its
    probes (each a host read) and time on the card against the port's own
    CPU float64 search (equal), then one configuration-4 pass at 1e6 rays
    on that grid beside phase 17's, ``hist_plot`` against its plain
    version;
32. custom fields (``SourceFromField``): example 22's infrared edge
    radiation at its sizes (101^2 pixels, R0 2500 mm, 3000 nodes x 6
    intervals) in float64 and float32, the map's time and the example's
    own checks (s/p > 3, p ratio > 10), the float32 map's distance from
    float64; ``tests/golden/ref_customfield.npz`` and
    ``ref_customfield_nf.npz`` in float64 (rtol 2e-4); the periodic test
    field's ray-mode shine (``tests/test_customfield.py``'s source) into
    a screen at 1e6 rays a pass, 2 passes, ``hist_plot`` against its
    plain version;
33. layouts, catalogs and stages: phase 31's beamline written to JSON and
    to XML, each loaded (``load_from_json`` / ``load_from_xml``) and traced
    one pass through ``propagate_flow`` with the same generator seed:
    histograms bit-identical to the original's; a DCM of
    ``catalogs.crystal('Ge', hkl=(1, 1, 1))`` against the catalog's Si at
    1e6 rays a pass (the mean energy within 1 eV, Ge's band > 1.5 x Si's,
    ``hist_plot`` against its plain version); ``DCMOnTripodWithOneXStage``
    at nominal jacks against the DCM in float64 (1e-9).

34. the multi-card layer (``xrt_tpu_torch.parallel``) on the one card,
    each path beside its unsharded run in the same process
    (``multicard_paths``): phase 3's chain split over the ranks
    (``WaveChain.build(mesh=)``) and with the ring, phase 4's toroid ->
    screen hop on B2 ('fast', 'exact'), phase 6's trace through
    ``run_ray_tracing(mesh=)`` (1e7 rays a rank x 4 passes) against the
    ordered sum of the ranks' unsharded passes with the same generators,
    phase 12's pitch gradient data-parallel (``sharded_trace``; B4 and
    B4-bwd) and phase 9's chain gradient through the sharded chain (B1,
    B3); the times, launches and the bytes the collectives moved.  (a) A
    world of 1 over NCCL (a file store in a temporary directory): every
    path bit-identical.  (b) A world of 2 processes on card 0 over gloo
    (NCCL refuses two ranks on one device; every collective stages its
    buffer through the host, the kernels run on the card): the chain and
    the hop to MC_CHAIN_LIMIT of the peak, the gradient to MC_GRAD_LIMIT,
    the trace and the data-parallel gradient bit for bit, both ranks
    alike.  On one card the times are the layer's cost, not scaling;
35. the command line on the card in subprocesses: ``info`` and ``trace
    --repeats 3`` on phase 33's JSON layout (the printed flux and good
    rays equal the API's with the same seed), ``calc rocking --R 2000``
    (Takagi-Taupin), ``codegen`` and the script it writes, ``qook
    BioXAS_Main.xml`` at 1e6 rays and ``serve`` answering list / get /
    set / acquire / shutdown from a ``BeamLineClient``; the nine reference
    xrtQook projects (``tests/data/qook``, which must be in the tree)
    loaded and traced in this process at 1e6 rays (pass time, good rays
    at least ``tests/test_qook.py``'s share), their plots through
    ``run_ray_tracing`` (``hist_plot``); and the profiler's report of a
    verbose ``run_ray_tracing`` of phase 6's trace, its stage times within
    10% of CUDA events around the run.  Nothing is rendered: the card's
    machine may lack matplotlib.
36. (in a fresh process of this script, ``--views``: after the earlier
    phases, phase 34b's spawned ranks among them, torch.profiler in this
    process no longer sees copies to pageable host memory) the views and
    control surfaces on phase 6's beamline at 1e7 rays a pass (float32, a
    recorded flow): (a) ``glow``: a scene's time and its
    device-to-host bytes (torch.profiler's memcpy events), its segments
    equal to numpy's on whole host copies of the beams, the HTML file,
    and ``bl.glow(scan=...)`` over five pitches (ms a frame; the
    post-mirror segments' end z rises with the pitch); (b) ``WebUI`` over
    loopback: ``/``, ``/api/elements``, ``/api/hist``, ``/api/probe`` at
    -500, 0 and 500 mm, ``/api/inspect``, ``/api/scene`` and three
    ``/api/set`` of the pitch (the focus moves by 2 dpitch q and comes
    back), each request's median ms over 3 and device-to-host bytes
    (under ``VIEWS_D2H_LIMIT``: no whole column); the /api/hist table from
    ``hist2d_kernel`` against ``hist2d_plain`` (float64 sums, 1e-5 of the
    peak, the same non-empty bins) and against ``np.histogram2d`` on a
    host copy (the rays both bin apart all within 4 ulp of an edge,
    counted); (c) subprocesses, each killed with its process group:
    ``serve --ui`` with phase 33's layout (``/api/hist``, ``/api/set``),
    ``serve --ui`` without one (an assembly from ``/api/registry``,
    reorder, remove, layout -> load, codegen), ``glow`` and ``bob``; (d)
    ``bob`` screens of the nine Qook projects, and ``EpicsIOC`` on a
    stand-in ``softioc`` module: three writes of the pitch, each a replay
    from the mirror, the image from ``hist2d_kernel`` bit-identical and
    the flux equal to a full re-trace's to 1e-9.

The ``kernels`` line adds B4's rows on these paths: ``hist2d_kernel`` at
speed test 1's shapes (phase 15's launches) and ``hist_plot`` on a DCM
pass (phase 16's); B1's at configuration 5's two hop shapes, 2e5 x 1e5
and 65536 x 2e5 (phase 18's launches, each against the plain version at
the full shape), ``hist_plot`` on a configuration-2 pass (phase
19's), ``hist_plot`` on a pass of each of phases 21-25 and 27-29, and
B1 and B3 at phase 26's two differentiated hops (M1 -> M2, 2e5 x 2e5;
M2 -> the screen, 16641 x 2e5; B3 held to the plain blocked backward on
slices, as in 5, its plain time from phase 26's reference step),
``hist_plot`` on a pass of each ray path of phases 30-33, and
``hist2d_kernel`` at the web UI's /api/hist table (phase 36's launches).

``python3 chip_smoke.py --sweep-plain-blocks`` only times the plain
blocked backward at 8192 x 16384 for four block sizes (the measurement
behind ``ops.kirchhoff.GRAD_DST_BLOCK`` / ``GRAD_SRC_CHUNK``).

The line before the last is the ``kernels`` JSON; the card line precedes
it; the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""
import collections
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

#: published peaks of one H100 SXM (dense, non-tensor float32), used for
#: the least time the card could take for a kernel's work
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12

#: f32 operations per (destination, source) pair, read off the kernel
#: sources term by term (a reciprocal, a square root, a rintf, cosf or
#: sinf each count as one operation, an FMA as two; two_prod is a multiply
#: and an FMA, 3):
#: B1 mono   — offsets 3, wp2 6, A 1, 1/A 1, x 2, delta series 6, delta 2,
#:             phase 9, reduction 2, sincos polynomials 22, lw 1, num 8,
#:             pre 4, U 3, ax/ay/az 9, f 1, g 8, ten sums 28      = 116
#: B2 fast   — dd differences 33, three two_prods 9, two_sums 12, lo 11,
#:             sqrt + 1/r 2, q 3, corr 5, k r two_prod 3, ml 4,
#:             frac 7, sincos 22, nsk 7, pre 2, U 3, f 1, g 8, sums 28
#:                                                                = 160
#: B2 exact  — dd differences 33, three dd squares 27, two dd adds 22,
#:             dd sqrt 21, kappa 10, kappa r 10, frac_two_pi 8, 1/r 1,
#:             cos + sin 2, nsk 7, pre 2, U 3, f 1, g 8, sums 28  = 183
#: The adjoints (B3), the least work for one pair: the forward pair without
#: its ten sums, one reverse sweep, and one add per cotangent row.
#: B3 mono   — forward 88; reverse: field cotangents 12, g's 10, ax/ay/az 9,
#:             f 3, h 2, ser/sei 6, U 22, k2 + 1/A seed 2, L 3, lw 5, pre +
#:             sin/cos 6, phase 4, inner/kw/num 8, n/Lns/lw 6, delta +
#:             kappa 4, series and 1/A 23, t 12                  = 137;
#:             sums: 6 destination rows, 20 source rows, 8 scalars = 34
#:                                                                = 259
#: B3 fast   — forward 132; reverse: the amplitude part 89, the phase part
#:             (kp, corr, s0, resid, 1/r, s2, the differences) 40  = 129;
#:             sums: 3 destination, 17 source rows = 20           = 281
#: B3 exact  — forward 155; reverse: the amplitude part 89, the phase part
#:             (frac_two_pi, kappa r, kp, dd sqrt, dd squares) 43 = 132;
#:             sums 20                                            = 307
#: The kernels evaluate each pair once (one pass, csrc/kirchhoff_bwd.cuh);
#: what they add to this is the sum of each pair's destination cotangents
#: over the warp (a transpose-reduce) and the partial sums across blocks.
OPS_PER_PAIR = {'kirchhoff_recentred:mono': 116,
                'kirchhoff_ddphase:fast': 160,
                'kirchhoff_ddphase:exact': 183,
                'kirchhoff_recentred_bwd:mono': 259,
                'kirchhoff_ddphase_bwd:fast': 281,
                'kirchhoff_ddphase_bwd:exact': 307}
#: f32 keys read per destination and per source, and outputs per
#: destination, of every kernel of the line (mono B1 and both B2 variants)
KEYS = (6, 20, 10)
SOURCES = {'kirchhoff_recentred': 'xrt_tpu_torch/csrc/kirchhoff_recentred.cu',
           'kirchhoff_ddphase': 'xrt_tpu_torch/csrc/kirchhoff_ddphase.cu',
           'kirchhoff_recentred_bwd':
           'xrt_tpu_torch/csrc/kirchhoff_recentred_bwd.cu',
           'kirchhoff_ddphase_bwd':
           'xrt_tpu_torch/csrc/kirchhoff_ddphase_bwd.cu',
           'hist2d': 'xrt_tpu_torch/csrc/hist2d.cu',
           'hist_plot': 'xrt_tpu_torch/csrc/hist_plot.cu',
           'kirchhoff_prep': 'xrt_tpu_torch/csrc/kirchhoff_prep.cu'}
REPLACES = {'kirchhoff_recentred': 'xrt_tpu/ops/kirchhoff.py:565',
            'kirchhoff_ddphase': 'xrt_tpu/ops/kirchhoff.py:903',
            'kirchhoff_recentred_bwd': 'xrt_tpu/ops/kirchhoff.py:1141',
            'kirchhoff_ddphase_bwd': 'xrt_tpu/ops/kirchhoff.py:1141',
            'hist2d': 'xrt_tpu/histogram.py:89',
            'hist_plot': 'xrt_tpu/histogram.py:89',
            'kirchhoff_prep': None}
#: the adjoint kernels against the plain blocked backward: the limit on
#: max|row - ref| / max|ref| of every key row and scalar's cotangent
ADJ_LIMIT = 1e-4
#: the slices of a main-path shape on which the plain blocked backward is
#: run: the last destinations (against all sources) and the last sources
#: (against all destinations), ragged ends included
ADJ_DST_SLICE, ADJ_SRC_SLICE = 8192, 2048
#: the gradients of the main path, adjoint kernels against the plain
#: blocked backward in their place (measured: <= 1.2e-7, the rows' 1e-5
#: differences average out over 2e5 samples)
GRAD_PLAIN_LIMIT = 1e-5
#: why the adjoint rows have no library time
NO_LIBRARY = ('no single PyTorch call computes the adjoint of the Kirchhoff '
              'double sum')

#: the trace main path: the beamline of the reference package's trace
#: benchmark at its ray count
TRACE_NRAYS = 10_000_000
TRACE_REPEATS = 4
TRACE_P, TRACE_Q, TRACE_PITCH = 10000.0, 2000.0, 4e-3

E0 = 500.0
P, Q, PITCH = 5000.0, 1000.0, 6e-3

#: the SoftiMAX chain (tools/torch_bench_softimax.py): samples per wave and
#: focal pixels of the main path, and the samples of the tiling check
SX_NRAYS, SX_NSCR, SX_TILE_NRAYS = 200_000, 64, 20_000
#: the float32 / float64 overlaps the deterministic SoftiMAX chain must
#: clear at each hop (tests/test_softimax_chain.py's own floors)
SX_FLOORS = {'slit': 0.999, 'm1': 0.999, 'm2': 0.999, 'wpg': 0.999,
             'pg': 0.7, 'm3': 0.6, 'es': 0.6, 'm4': 0.6, 'm5': 0.6,
             'focus': 0.55}
SX_GOLDEN = 'tests/golden/ref_softimax.npz'

#: xrt's speed test 1 (tools/torch_bench_analyzer.py): rays a step and
#: steps a source, nothing cut
AN_NRAYS, AN_REPEATS = 100_000, 96
#: phase 37, the toroid search kernel: rays of the float32 and float64
#: checks; the share of rays whose t may differ from the generic search's
#: by more than 4 ulp (float32) or 1e-9 mm (float64), and the s and p flux
#: of the reflected beams (relative)
TS_NRAYS, TS_NRAYS_F64 = 10_000_000, 1_000_000
TS_T_SHARE, TS_FLUX_LIMIT = 1e-4, 1e-5
#: the DCM trace at the geometry of the golden (tests/test_trace_parity.py)
DCM_E0, DCM_P = 9000.0, 30000.0
DCM_GOLDEN = 'tests/golden/ref_trace_dcm.npz'
DCM_CROSS_NRAYS = 200_000
#: BASELINE configuration 4: rays a pass (4 candidates a ray through the
#: undulator integral) and passes
C4_NRAYS, C4_REPEATS = 1_000_000, 2
#: BASELINE configuration 5 (tests/test_baseline_configs.py:156-198): the
#: energy, focal length and zones of the zone plate; filaments, samples at
#: the slit and on the zone plate, focal pixels a side and modes; the
#: float32 / float64 cross-check's sizes; the last destinations of each B1
#: launch held against the plain version
C5_E0, C5_F, C5_N = 9000.0, 2000.0, 60
C5_ELECTRONS, C5_NSLIT, C5_NFZP, C5_NFOCUS, C5_MODES = \
    256, 100_000, 200_000, 256, 8
C5_CROSS = dict(electrons=32, nslit=20_000, nfzp=20_000, nfocus=64)
C5_CHECK_DST = 2048
#: the hops of configuration 5: monochromatic, the exact f32 sums
C5_HOP = dict(monochromatic=True, accumulate='vpu', narrowband=False)
#: BASELINE configuration 2 (tests/test_baseline_configs.py:54-81): rays a
#: pass, passes, the cross-check's rays, and the geometry
C2_NRAYS, C2_REPEATS, C2_CROSS_NRAYS = 10_000_000, 4, 200_000
C2_P, C2_Q, C2_PITCH = 15000.0, 5000.0, 5e-3
SOURCES_GOLDEN = 'tests/golden/ref_sources.npz'
#: the field maps' s0, float32 against float64: max|d| / max
MAP_F32_LIMIT = 1e-5


class PhaseError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def rel_err(got, ref):
    """max over the five outputs of max|got - ref| / max|ref|, and the
    max absolute difference."""
    rel, ab = 0.0, 0.0
    for g, r in zip(got, ref):
        d = float((g - r).abs().max())
        scale = float(r.abs().max())
        if scale > 0:
            rel = max(rel, d / scale)
        elif d > 0:     # an output that is identically zero, e.g. Ep
            rel = math.inf
        ab = max(ab, d)
    return rel, ab


def cuda_ms(fn, n=1):
    """Mean device time of *n* calls of *fn*, by CUDA events."""
    import torch
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        out = fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / n, out


def bound_ms(name, nd, ns):
    kd, ks, ko = KEYS
    t_ops = OPS_PER_PAIR[name] * nd * ns / PEAK_F32_OPS
    if '_bwd' in name:      # reads D, S and G, writes the cotangents of D, S
        t_bytes = 4.0 * (2 * kd * nd + 2 * ks * ns + ko * nd) / PEAK_BYTES
    else:
        t_bytes = 4.0 * (kd * nd + ks * ns + ko * nd) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        'operations' if t_ops >= t_bytes else 'bytes'


def beamline(dtype, device):
    from xrt_tpu_torch.apertures import RectangularAperture
    from xrt_tpu_torch.materials import Material
    from xrt_tpu_torch.oes import ToroidMirror
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import GaussianBeam
    mat = Material.create('Au', rho=19.3, kind='mirror', dtype=dtype,
                          device=device)
    R = 2 * P * Q / (P + Q) / math.sin(PITCH)
    r = 2 * P * Q / (P + Q) * math.sin(PITCH)
    src = GaussianBeam.create(w0=0.05, distE='lines', energies=(E0,),
                              polarization='horizontal')
    slit = RectangularAperture.create(center=(0, 0, 0),
                                      opening=(-0.3, 0.3, -0.15, 0.15))
    tor = ToroidMirror.create(center=(0, P, 0), pitch=PITCH, R=R, r=r,
                              material=mat, limPhysX=(-3, 3),
                              limPhysY=(-40, 40))
    scr = Screen.create(
        center=(0, P + Q * math.cos(2 * PITCH), Q * math.sin(2 * PITCH)),
        z=(0, -math.sin(2 * PITCH), math.cos(2 * PITCH)))
    return src, slit, tor, scr


def build_chain(nrays, npix, dtype, seed=1, **kw):
    import numpy as np
    import torch
    from xrt_tpu_torch.wavechain import WaveChain
    src, slit, tor, scr = beamline(dtype, 'cuda')
    grid = np.linspace(-0.02, 0.02, npix)
    chain = (WaveChain(src, nrays=nrays, fixedEnergy=E0)
             .through_aperture(slit).through_oe(tor)
             .to_screen(scr, grid, grid))
    run = chain.build(torch.Generator().manual_seed(seed), dtype=dtype,
                      device='cuda', **kw)
    return run, (src, slit, tor, scr)


def phase_card():
    import torch
    from xrt_tpu_torch.ops import _cuda
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f'phase 1 card: {card}; python {sys.version.split()[0]}, torch '
          f'{torch.__version__}, CUDA {torch.version.cuda}', flush=True)
    t0 = time.perf_counter()
    _cuda.build()
    t = time.perf_counter() - t0
    print(f'phase 1 build: {len(_cuda.SOURCES)} sources with nvcc in '
          f'{t:.2f} s', flush=True)
    for name in ('kirchhoff_recentred', 'kirchhoff_ddphase',
                 'kirchhoff_recentred_bwd', 'kirchhoff_ddphase_bwd',
                 'hist2d', 'hist_plot', 'toroid_search'):
        for fn, regs, st, ld in ptxas_rows(_cuda.build_log(name)):
            print(f'phase 1 ptxas {name} {fn}: {regs} registers, spill '
                  f'stores {st} B, loads {ld} B', flush=True)
    return card


def ptxas_rows(log):
    """[(kernel, registers, spill store bytes, spill load bytes)] of a
    build log (``-Xptxas -v``); kernels by their mangled names."""
    import re
    rows, fn, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn, spill = m.group(1), (0, 0)
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r'Used (\d+) registers', line)
        if m and fn:
            rows.append((fn, int(m.group(1)), *spill))
            fn = None
    return rows


def kernel_registers(scheme, v, adjoint=False):
    """(registers, spill bytes) of the forward (B1, B2) or adjoint (B3)
    kernel of one variant."""
    from xrt_tpu_torch.ops import _cuda
    pair = 'RecentredPair' if scheme == 'recentred' else 'DDPair'
    lib, fn_name = (f'kirchhoff_{scheme}_bwd', 'adjoint_kernel') if adjoint \
        else (f'kirchhoff_{scheme}', 'forward_kernel')
    for fn, regs, st, ld in ptxas_rows(_cuda.build_log(lib)):
        if fn_name in fn and f'{pair}ILi{v}E' in fn:
            return regs, st + ld
    raise PhaseError(f'no ptxas line for {lib} {v}')


def kernel_case_args(mode, Nd=8192, Ns=16384, seed=3):
    """The beamline-like geometry of the reference package's MXU parity
    test: a 1 x 0.1 x 1 mm source cloud and a 2 x 2 mm destination patch
    10 m away, 9 keV."""
    import numpy as np
    import torch
    from xrt_tpu_torch.ops import dd
    from xrt_tpu_torch.physconsts import CHBAR
    rng = np.random.RandomState(seed)
    xs = rng.uniform(-0.5, 0.5, Ns)
    ys = rng.uniform(-0.05, 0.05, Ns)
    zs = rng.uniform(-0.5, 0.5, Ns)
    xd = rng.uniform(-1, 1, Nd)
    yd = np.full(Nd, 10000.0)
    zd = rng.uniform(-1, 1, Nd)
    Es = np.exp(1j * rng.uniform(0, 2 * np.pi, Ns))
    kk = np.full(Ns, 9000.0 / CHBAR * 1e7)
    if mode != 'mono':
        kk = kk * (1 + rng.uniform(-1e-4, 1e-4, Ns))

    def T(v, dt=None):
        return torch.as_tensor(v, dtype=dt).cuda()

    def D(v):
        return tuple(T(a) for a in dd.from_f64(v))
    f32 = torch.float32
    return (D(xd), D(yd), D(zd), D(xs), D(ys), D(zs),
            T(Es, torch.complex64), T(0.3 * Es, torch.complex64), D(kk),
            [T(np.full(Ns, v), f32) for v in (0.01, 0.99, 0.02)],
            T(np.full(Ns, 0.9), f32), T(np.ones(Ns), f32))


def phase_kernels():
    import torch
    from xrt_tpu_torch.ops import dd, kirchhoff as tk
    for mode in ('mono', 'narrowband', 'poly'):
        args = kernel_case_args(mode)
        kw = dict(monochromatic=mode == 'mono',
                  narrowband=mode == 'narrowband')
        ref = tk.kirchhoff_integral_recentred(*args, **kw)
        worst = 0.0
        for acc in ('vpu', 'mxu', 'mxu2', 'mxu-fast', 'mxu32'):
            got = tk.kirchhoff_integral_kernel(*args, accumulate=acc, **kw)
            rel, _ = rel_err(got, ref)
            worst = max(worst, rel)
            check(rel < 2e-5, f'B1 {mode}/{acc}: {rel:.3e} >= 2e-5')
        print(f'phase 2 B1 {mode}: kernel vs plain, all accumulate '
              f'values, max rel {worst:.2e}', flush=True)
    for pm in ('fast', 'exact'):
        args = kernel_case_args('poly')
        ref = tk.kirchhoff_integral_dd(*args, phase_mode=pm)
        got = tk.kirchhoff_integral_kernel(*args, phase_mode=pm)
        rel, _ = rel_err(got, ref)
        check(rel < 2e-5, f'B2 {pm}: {rel:.3e} >= 2e-5')
        print(f'phase 2 B2 {pm}: kernel vs plain max rel {rel:.2e}',
              flush=True)
    g = torch.Generator().manual_seed(0)
    n = 1_000_000
    a = (torch.rand(n, generator=g, dtype=torch.float64) * 2e4 - 1e4)
    b = (torch.rand(n, generator=g, dtype=torch.float64) * 2 - 1)
    c = (torch.rand(n, generator=g, dtype=torch.float64) - 0.5)

    def logu(lo, hi, m):
        e = torch.rand(m, generator=g, dtype=torch.float64) * (hi - lo) + lo
        sign = torch.where(torch.rand(m, generator=g) < 0.5, -1.0, 1.0)
        return sign * 10.0 ** e
    # products the kernels form: position differences of 1e-6 to 1e5 mm
    # against each other and themselves, kappa (1e6 to 1e8 / mm) times r
    # (1e2 to 1e5 mm)
    m = n // 4
    sq = logu(-6, 5, m)
    wide_a = torch.cat([logu(-6, 5, m), sq, logu(6, 8, m).abs(), a[:m]])
    wide_b = torch.cat([logu(-6, 5, m), sq, logu(2, 5, m).abs(), b[:m]])
    for name, (x, y) in (('uniform', (a, b)), ('spanning', (wide_a,
                                                            wide_b))):
        x, y, z = (v.float().cuda() for v in (x, y, c))
        got = dd.selftest(x, y, z)
        plain = torch.stack([*dd.two_sum(x, y), *dd.two_prod(x, y),
                             dd.frac_cycles(x, y), *dd.sincos_cycles(z)])
        cpu = dd.selftest(x.cpu(), y.cpu(), z.cpu()).cuda()
        bad = int((got != plain).sum()) + int((got != cpu).sum())
        check(bad == 0, f'dd helpers differ from plain torch in {bad} '
              f'values ({name} inputs)')
        print(f'phase 2 dd helpers: two_sum, two_prod (one FMA), '
              f'frac_cycles, sincos_cycles bit-identical to plain torch '
              f'(card and CPU; two_prod the Dekker product) on {n} {name} '
              f'inputs', flush=True)
    # B2 'exact' takes sin and cos from one sincosf: only because they are
    # the bits of sinf and cosf, which its adjoint recomputes
    x = torch.cat([(4 * torch.rand(n, generator=g, dtype=torch.float64) -
                    2) * math.pi, torch.tensor(
        [0.0, -0.0, math.pi / 2, -math.pi / 2, math.pi, -math.pi,
         2 * math.pi, -2 * math.pi, 1e-30, 3e-39, 1e5, -1e5, 1e30])])
    bad = sincosf_mismatches(x.float().cuda())
    check(bad == 0, f'sincosf differs from sinf / cosf in {bad} values')
    print(f'phase 2 sincosf: sin and cos bit-identical to sinf and cosf on '
          f'{x.numel()} phases (B2 \'exact\' takes them from one sincosf)',
          flush=True)


def sincosf_mismatches(x):
    """The values of the CUDA tensor *x* where one sincosf on the card
    does not give the bits of sinf and cosf."""
    import ctypes
    import torch
    from xrt_tpu_torch.ops import _cuda
    out = torch.empty((4, x.numel()), device=x.device)
    _cuda.launch('dd_selftest', 'sincosf_selftest_launch',
                 [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_void_p], x.device,
                 x.data_ptr(), x.numel(), out.data_ptr())
    return int(((out[0] != out[2]) | (out[1] != out[3])).sum())


def phase_main(timing):
    import numpy as np
    import torch
    from xrt_tpu_torch.ops import kirchhoff as tk
    from xrt_tpu_torch.wavechain import WaveChain
    nrays, npix = 200_000, 256
    t0 = time.perf_counter()
    run, els = build_chain(nrays, npix, torch.float32)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    pairs = [nrays * nrays, nrays * npix * npix]
    tk.LAUNCHES.clear()
    hops = []
    w, logs = run(torch.Generator().manual_seed(2))  # warm-up
    torch.cuda.synchronize()
    times = []
    for rep in range(3):
        t0 = time.perf_counter()
        w, logs = run(torch.Generator().manual_seed(2),
                      timings=hops if rep == 2 else None)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(tk.LAUNCHES)
    I = WaveChain.absolute_intensity(w, logs)
    check(np.all(np.isfinite(I)) and I.max() > 0,
          'main path: intensity not finite or all zero')
    med = statistics.median(times)
    for hrec in hops:
        ms = hrec['start'].elapsed_time(hrec['end'])
        i = hrec['hop']
        print(f'phase 3 hop {i}: mode {hrec["mode"]}, '
              f'{pairs[i - 1]:.3e} pairs, stage {ms:.2f} ms (CUDA events, '
              f'last timed run)', flush=True)
    print(f'phase 3 chain: {nrays} samples/wave, {npix}x{npix} screen, '
          f'float32; build {t_build:.2f} s; run median of 3 '
          f'{med * 1e3:.1f} ms ({", ".join(f"{t * 1e3:.1f}" for t in times)}'
          f'); {sum(pairs) / med:.3e} pairs/s; I max {I.max():.6e}; '
          f'launches {launches}', flush=True)
    check(launches.get('kirchhoff_recentred:mono', 0) >= 2 * 4,
          f'main path did not launch B1 on both hops: {launches}')
    check(set(launches) == {'kirchhoff_recentred:mono', 'prep:mono'} and
          launches['prep:mono'] == launches['kirchhoff_recentred:mono'],
          f'unexpected launches on the main path: {launches}')
    timing['main'] = dict(run=run, els=els, launches=launches,
                          pairs=pairs)


def hop_inputs(run, els):
    """The float32 chain driven hop by hop to the toroid -> screen stage:
    (source beam, receiving wave) of each stage."""
    import torch
    from xrt_tpu_torch import waves as W
    src, slit, tor, scr = els
    wv = run.waves
    cur = W._shine_or_diffract(None, wv[0], torch.Generator().manual_seed(2))
    cur, l0 = W.rescale_field(cur)
    b = W.diffract(cur, wv[1], phase_mode=run.modes[1][0],
                   monochromatic=True, accumulate=run.modes[1][1],
                   narrowband=False)
    _, loc = W.reflect_wave(tor, b)
    loc, l1 = W.rescale_field(loc)
    return [(cur, wv[1]), (loc, wv[2])], l0 + l1


def time_kernel(name, variant, stage, with_plain=True):
    """(kernel ms, plain ms, max abs err, rel err, Nd, Ns, extra) of one
    kernel at one stage's shapes: the kernel alone by CUDA events (median
    of 3), the plain version once (or skipped: None for its three numbers);
    *extra* holds the time of its second kernel (the sum of the source
    groups' partials), its scratch bytes, registers and spill bytes.
    *stage* is (source beam, receiving wave), or the kernel arguments of a
    tile pair as a list."""
    import torch
    from xrt_tpu_torch import waves as W
    from xrt_tpu_torch.ops import kirchhoff as tk
    args = stage if isinstance(stage, list) else \
        W.kirchhoff_kernel_args(*stage)
    xd, yd, zd, xs, ys, zs, Es, Ep, k, n, nl, w = args
    Nd, Ns = xd[0].shape[0], xs[0].shape[0]
    scheme, v, D, S, P = tk._kernel_inputs(*args, variant)
    S = tk._pad_sources(S)
    launch = lambda: tk._launch_rows(scheme, v, *tk._forward_inputs(D, S, P),
                                     Ns)
    if name == 'kirchhoff_recentred':
        plain = lambda: tk.kirchhoff_integral_recentred(
            *args, monochromatic=True)
    else:
        plain = lambda: tk.kirchhoff_integral_dd(*args, phase_mode=variant)
    launch()
    torch.cuda.synchronize()
    ms = statistics.median(cuda_ms(launch)[0] for _ in range(3))
    part = tk._forward_launch(scheme, v, *tk._forward_inputs(D, S, P))
    red_ms = statistics.median(cuda_ms(lambda: tk._forward_reduce(
        name, part))[0] for _ in range(3))
    regs, spill = kernel_registers(scheme, v)
    extra = dict(reduce_ms=red_ms, scratch_bytes=part.numel() * 4,
                 registers=regs, spill_bytes=spill,
                 grid=tk.forward_grid(Nd, tk.forward_sources(S).shape[0]))
    del part
    if not with_plain:
        return ms, None, None, None, Nd, Ns, extra
    out = tk._complex5(launch())
    plain_ms, ref = cuda_ms(plain)
    rel, ab = rel_err(out, ref)
    return ms, plain_ms, ab, rel, Nd, Ns, extra


def phase_cross(timing):
    import numpy as np
    import torch
    from xrt_tpu_torch import waves as W
    from xrt_tpu_torch.ops import kirchhoff as tk
    from xrt_tpu_torch.wavechain import WaveChain
    res = {}
    for dt in (torch.float32, torch.float64):
        run, _ = build_chain(20_000, 64, dt, seed=4)
        w, logs = run(torch.Generator().manual_seed(5))
        res[dt] = WaveChain.absolute_intensity(w, logs)
    I32, I64 = res[torch.float32], res[torch.float64]
    err = float(np.max(np.abs(I32 - I64)) / np.max(I64))
    print(f'phase 4 float32 kernels vs float64 plain path, 2e4 samples, '
          f'64x64 screen: max|dI|/max I {err:.3e}', flush=True)
    check(err < 5e-3, f'f32 vs f64 chain: {err:.3e} >= 5e-3')

    main = timing['main']
    stages, logs = hop_inputs(main['run'], main['els'])
    oeLocal, wave = stages[1]
    out = {}
    tk.LAUNCHES.clear()
    for pm in ('recentred', 'fast', 'exact'):
        o = W.diffract(oeLocal, wave, phase_mode=pm, monochromatic=True,
                       accumulate='mxu-fast', narrowband=False)
        out[pm] = (o.Jss + o.Jpp).double().cpu().numpy()
    torch.cuda.synchronize()
    launches = dict(tk.LAUNCHES)
    ref = out['recentred']
    for pm in ('fast', 'exact'):
        e = float(np.max(np.abs(out[pm] - ref)) / np.max(ref))
        print(f'phase 4 toroid -> screen hop at full size, B2 {pm} vs '
              f'recentred: max|dI|/max I {e:.3e}', flush=True)
        check(e < 5e-3, f'B2 {pm} vs recentred: {e:.3e} >= 5e-3')
        check(launches.get(f'kirchhoff_ddphase:{pm}', 0) >= 1,
              f'B2 {pm} was not launched: {launches}')
    print(f'phase 4 launches of the B2 run: {launches}', flush=True)
    timing['b2_launches'] = launches
    timing['stages'] = stages


def phase_kernel_line(timing):
    rows = []
    stages = timing['stages']
    for hop, stage in enumerate(stages, 1):
        ms, _, _, _, Nd, Ns, ex = time_kernel('kirchhoff_recentred', 'mono',
                                              stage, with_plain=False)
        bms, _ = bound_ms('kirchhoff_recentred:mono', Nd, Ns)
        print(f'phase 5 hop {hop} kernel B1 alone: {Nd} x {Ns} pairs, '
              f'{ms:.2f} ms, '
              f'{Nd * Ns / (ms * 1e-3):.3e} pairs/s, {bms / ms:.1%} of its '
              f'operation bound {bms:.2f} ms; grid {ex["grid"][0]} tiles x '
              f'{ex["grid"][1]} source groups, the sum of their partials '
              f'{ex["reduce_ms"]:.3f} ms ({ex["reduce_ms"] / ms:.2%}), '
              f'scratch {ex["scratch_bytes"] / 2 ** 20:.1f} MiB; '
              f'{ex["registers"]} registers, {ex["spill_bytes"]} B spilled',
              flush=True)
    specs = [('kirchhoff_recentred', 'mono', stages[0],
              timing['main']['launches']),
             ('kirchhoff_ddphase', 'fast', stages[1],
              timing['b2_launches']),
             ('kirchhoff_ddphase', 'exact', stages[1],
              timing['b2_launches'])]
    for name, variant, stage, launches in specs:
        key = f'{name}:{variant}'
        ms, plain_ms, ab, rel, Nd, Ns, ex = time_kernel(name, variant,
                                                        stage)
        check(rel < 2e-5, f'{key} at main-path shapes: {rel:.3e}')
        bms, by = bound_ms(key, Nd, Ns)
        print(f'phase 5 {key}: {Nd} x {Ns} pairs, kernel {ms:.2f} ms (the '
              f'sum of the groups\' partials {ex["reduce_ms"]:.3f} ms of '
              f'it), plain {plain_ms:.1f} ms, bound {bms:.2f} ms ({by}), '
              f'{bms / ms:.1%} of bound, {Nd * Ns / (ms * 1e-3):.3e} pairs/s, '
              f'max rel {rel:.2e}; {ex["registers"]} registers, '
              f'{ex["spill_bytes"]} B spilled', flush=True)
        rows.append(dict(name=key, route='cuda', source=SOURCES[name],
                         replaces=REPLACES[name],
                         launches=int(launches.get(key, 0)),
                         max_abs_err=ab, max_rel_err=rel, ms=ms,
                         reduce_ms=ex['reduce_ms'],
                         scratch_bytes=ex['scratch_bytes'],
                         registers=ex['registers'],
                         spill_bytes=ex['spill_bytes'], plain_ms=plain_ms,
                         bound_ms=bms, bound_by=by, library_ms=None))
    return rows


# ---------------------------------------------------------------------------
# the histogram kernel (B4) and the trace path
# ---------------------------------------------------------------------------

def hist_case(case, k, n=TRACE_NRAYS, seed=0):
    """(x, y, W, xbins, ybins, xlimits, ylimits) of one check of the
    histogram kernel, float32 on the card."""
    import numpy as np
    import torch
    g = torch.Generator('cuda').manual_seed(seed)
    xlim, ylim = (-1.0, 1.3), (-0.5, 1.7)   # spans with inexact reciprocals
    xbins = ybins = 128
    if case == 'ragged':
        n = 1_234_567

    def rand(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=g, device='cuda')
    x, y = rand(-1.1, 1.4), rand(-0.6, 1.8)
    if case == 'global':
        xbins = ybins = 1024
    elif case == '1d':
        ybins, y, ylim = 1, None, None
    elif case == 'focused':     # 95% of the rays in four bins
        sel = rand(0, 1) < 0.95
        x = torch.where(sel, rand(0.0, 2 * 2.3 / 128), x)
        y = torch.where(sel, rand(0.5, 0.5 + 2 * 2.2 / 128), y)
    elif case == 'special':
        ex = np.linspace(*xlim, xbins + 1)
        ey = np.linspace(*ylim, ybins + 1)
        extra = np.array([np.nan, np.inf, -np.inf, -7.0, 9.0])
        xs = np.concatenate([ex, extra, ex, np.nextafter(ex, 9)])
        ys = np.concatenate([ey, ey[:5], extra, ey[::-1], ey * 0.999])
        m = xs.size
        x = torch.cat([torch.as_tensor(xs, dtype=torch.float32).cuda(),
                       x[:100_000]])
        y = torch.cat([torch.as_tensor(ys[:m], dtype=torch.float32).cuda(),
                       y[:100_000]])
        n = x.shape[0]
    W = 0.5 + torch.rand((n, k), generator=g, device='cuda')
    return x, y, W, xbins, ybins, xlim, ylim


def hist_errors(got, ref):
    """(max|h - h64| / max|h64|, max abs difference, whether the sets of
    non-empty bins are identical)."""
    import torch
    d = float((got.double() - ref).abs().max())
    return d / float(ref.abs().max()), d, bool(torch.equal(got != 0,
                                                           ref != 0))


def bits_equal(a, b):
    """Whether two histograms (tensors or dicts of them) have the same bits
    (NaN included)."""
    import torch
    if isinstance(a, dict):
        return all(bits_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(
        a.view(torch.int32 if a.dtype == torch.float32 else torch.int64),
        b.view(torch.int32 if b.dtype == torch.float32 else torch.int64))


def plot_case(case, bins, n=TRACE_NRAYS, seed=1):
    """The arguments of ``hist_plot_kernel`` for one check: rays as
    ``hist_case``'s, cData over a hue range, flux and w2d, a plot mask."""
    import numpy as np
    import torch
    g = torch.Generator('cuda').manual_seed(seed)

    def rand(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=g, device='cuda')
    x, y = rand(-1.1, 1.4), rand(-0.6, 1.8)
    c = rand(8870.0, 9130.0)
    flux = rand(0.0, 2.0)
    w2d = flux * rand(0.5, 1.0)
    mask = rand(0, 1) < 0.9
    xlim, ylim, clim = (-1.0, 1.3), (-0.5, 1.7), (8890.0, 9110.0)
    if case == 'focused':       # 95% of the rays in four bins of each axis
        sel = rand(0, 1) < 0.95
        x = torch.where(sel, rand(0.0, 2 * 2.3 / bins), x)
        y = torch.where(sel, rand(0.5, 0.5 + 2 * 2.2 / bins), y)
        c = torch.where(sel, rand(9000.0, 9000.0 + 440.0 / bins), c)
    elif case == 'special':     # edges, NaN and +-inf in every input
        for v, (lo, hi) in ((x, xlim), (y, ylim), (c, clim)):
            v[:bins + 1] = torch.from_numpy(np.linspace(lo, hi, bins + 1))
        bad = torch.tensor([np.nan, np.inf, -np.inf, 0.0, 7.0])
        for j, v in enumerate((x, y, c, flux, w2d)):
            v[2000 + 10 * j:2005 + 10 * j] = bad
    return (x, y, c, flux, w2d, mask, (bins, bins, bins), (xlim, ylim, clim),
            0.85, 1.0)


def plot_errors(got, ref):
    """(max over the eight histograms and the total of max|h - h64| /
    max|h64| on the finite bins, whether the non-empty, NaN and infinite
    bins are the same)"""
    import torch
    from xrt_tpu_torch import histogram as th
    rel, same = 0.0, True
    for k in th.PLOT_HISTS + ('intensity',):
        g, r = got[k], ref[k]
        fin = torch.isfinite(r)
        same &= bool(torch.equal(torch.isnan(g), torch.isnan(r)) and
                     torch.equal(g[~fin & ~torch.isnan(r)],
                                 r[~fin & ~torch.isnan(r)].to(g.dtype)) and
                     torch.equal(g[fin] != 0, r[fin] != 0))
        if fin.any():
            rel = max(rel, float((g[fin].double() - r[fin]).abs().max() /
                                 r[fin].abs().max()))
    return rel, same


def phase_hist_kernel():
    import torch
    from xrt_tpu_torch import histogram as th
    for case in ('shared', 'global', '1d', 'focused', 'special', 'ragged'):
        for k in (1, 3):
            args = hist_case(case, k)
            got = th.hist2d_kernel(*args)
            again = th.hist2d_kernel(*args)
            torch.cuda.synchronize()
            ref = th.hist2d_plain(*args, sum_dtype=torch.float64)
            rel, _, same = hist_errors(got, ref)
            twice = bits_equal(got, again)
            lim = 1e-4 if case == 'focused' else 1e-5
            print(f'phase 2 B4 {case} k={k}: {args[0].shape[0]} rays into '
                  f'{args[4]} x {args[3]}, kernel vs plain (float64 sums) '
                  f'max rel {rel:.2e} (limit {lim:.0e}), non-empty bins '
                  f'{"identical" if same else "DIFFER"}, two launches '
                  f'{"bit-identical" if twice else "DIFFER"}', flush=True)
            check(rel < lim, f'B4 {case} k={k}: {rel:.3e} >= {lim:.0e}')
            check(same, f'B4 {case} k={k}: the sets of non-empty bins '
                  'differ')
            check(twice, f'B4 {case} k={k}: two launches differ')
    # every route that takes the table gives the same bits
    for k in (1, 3):
        for bins in (64, 128):
            x, y, W, _, _, xlim, ylim = hist_case('focused', k, n=1_000_000)
            first = th.ROUTES.index(th.hist_route(bins, bins, k))
            outs = {r: th.hist2d_kernel(x, y, W, bins, bins, xlim, ylim,
                                        route=r)
                    for r in th.ROUTES[first:]}
            same = all(bits_equal(outs[r], o) for r in outs
                       for o in outs.values())
            print(f'phase 2 B4 k={k} {bins} x {bins}: routes {list(outs)} '
                  f'{"bit-identical" if same else "DIFFER"}', flush=True)
            check(same, f'B4 k={k} {bins}: routes differ')
    # non-finite weights give the float sum's NaN / +-inf, on every route
    x, y, W, _, _, xlim, ylim = hist_case('shared', 3, n=1_000_000)
    W[:7, 0] = torch.tensor([float('nan'), float('inf'), -float('inf'),
                             float('inf'), float('inf'), -float('inf'), 1.0])
    W[3:5, 1] = float('inf')
    ref = th.hist2d_plain(x, y, W, 64, 64, xlim, ylim,
                          sum_dtype=torch.float64)
    for r in th.ROUTES:
        got = th.hist2d_kernel(x, y, W, 64, 64, xlim, ylim, route=r)
        fin = torch.isfinite(ref)
        ok = torch.equal(torch.isnan(got), torch.isnan(ref)) and \
            torch.equal(got[~fin & ~torch.isnan(ref)],
                        ref[~fin & ~torch.isnan(ref)].float())
        check(ok and int((~fin).sum()) > 0,
              f'B4 {r}: non-finite weights not as index_add_ gives them')
    x, y, W, xbins, ybins, xlim, ylim = hist_case('shared', 3, n=1_000_000)
    d = th.hist2d_kernel(x.double(), y.double(), W.double(), xbins, ybins,
                         xlim, ylim)
    ref = th.hist2d_plain(x.double(), y.double(), W.double(), xbins, ybins,
                          xlim, ylim)
    rel64 = float((d - ref).abs().max() / ref.abs().max())
    check(rel64 < 1e-12, f'B4 float64 kernel vs plain: {rel64:.3e}')
    print(f'phase 2 B4: non-finite weights as index_add_ gives them on the '
          f'shared-memory and device-memory routes; float64 kernel vs plain '
          f'{rel64:.2e}', flush=True)
    # a plot's eight histograms in one launch (hist_plot)
    for bins in (128, 1024):
        for case in ('uniform', 'focused', 'special'):
            args = plot_case(case, bins)
            got = th.hist_plot_kernel(*args)
            again = th.hist_plot_kernel(*args)
            ref = th.hist_plot_plain(*args, sum_dtype=torch.float64)
            rel, same = plot_errors(got, ref)
            twice = bits_equal(got, again)
            lim = 1e-4 if case == 'focused' else 1e-5
            print(f'phase 2 hist_plot {case} {bins} bins: eight histograms '
                  f'vs plain (float64 sums) max rel {rel:.2e} (limit '
                  f'{lim:.0e}), non-empty and non-finite bins '
                  f'{"identical" if same else "DIFFER"}, two launches '
                  f'{"bit-identical" if twice else "DIFFER"}', flush=True)
            check(rel < lim, f'hist_plot {case} {bins}: {rel:.3e}')
            check(same, f'hist_plot {case} {bins}: bins differ')
            check(twice, f'hist_plot {case} {bins}: two launches differ')
    for bins in (32, 64):
        args = plot_case('focused', bins, n=1_000_000)
        first = th.ROUTES.index(th.plot_route((bins,) * 3))
        outs = [th.hist_plot_kernel(*args, route=r)
                for r in th.ROUTES[first:]]
        same = all(bits_equal(outs[0], o) for o in outs[1:])
        d64 = [v.double() if v.is_floating_point() else v for v in args[:6]]
        got = th.hist_plot_kernel(*d64, *args[6:])
        ref = th.hist_plot_plain(*d64, *args[6:])
        rel64 = max(float((got[k] - ref[k]).abs().max() / ref[k].abs().max())
                    for k in th.PLOT_HISTS)
        print(f'phase 2 hist_plot {bins} bins: routes '
              f'{list(th.ROUTES[first:])} '
              f'{"bit-identical" if same else "DIFFER"}; float64 kernel vs '
              f'plain {rel64:.2e}', flush=True)
        check(same, f'hist_plot {bins}: routes differ')
        check(rel64 < 1e-12, f'hist_plot float64 {bins}: {rel64:.3e}')


def trace_beamline(nrays, dtype):
    """The beamline of the reference package's trace benchmark:
    GeometricSource -> Si toroid (p = 10 m, q = 2 m, 4 mrad) -> screen."""
    from xrt_tpu_torch.materials import Material
    from xrt_tpu_torch.oes import ToroidMirror
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import GeometricSource
    p, q, pitch = TRACE_P, TRACE_Q, TRACE_PITCH
    mat = Material.create('Si', rho=2.33, kind='mirror', dtype=dtype,
                          device='cuda')
    src = GeometricSource.create(
        nrays=nrays, center=(0, 0, 0), dx=0.1, dz=0.05, dxprime=3e-5,
        dzprime=3e-5, distE='flat', energies=(8900.0, 9100.0),
        polarization='horizontal', dtype=dtype, device='cuda')
    tor = ToroidMirror.create(center=(0, p, 0), pitch=pitch, R=(p, q),
                              r=(p, q), material=mat, limPhysX=(-20, 20),
                              limPhysY=(-300, 300))
    scr = Screen.create(center=(0, p + q, 2 * pitch * q))
    return src, tor, scr


def trace_plot(bins):
    from xrt_tpu_torch.plotspec import XYCAxis, XYCPlot
    return XYCPlot(beam='screen', xaxis=XYCAxis('x', 'mm', bins=bins),
                   yaxis=XYCAxis('z', 'mm', bins=bins),
                   caxis=XYCAxis('energy', 'eV', bins=bins))


def events(n):
    import torch
    return [torch.cuda.Event(enable_timing=True) for _ in range(n)]


def phase_trace(timing):
    import torch
    from xrt_tpu_torch import histogram as th, runner
    from xrt_tpu_torch.oes import base as oebase
    from xrt_tpu_torch.ops import kirchhoff as tk
    from xrt_tpu_torch.transforms import global_to_virgin_local, rotate_beam
    n, reps = TRACE_NRAYS, TRACE_REPEATS
    src, tor, scr = trace_beamline(n, torch.float32)
    entries = []

    def run_process(beamLine, rng):
        torch.cuda.synchronize()
        entries.append(time.perf_counter())
        glo, _ = tor.reflect(src.shine(rng))
        return {'screen': scr.expose(glo)}

    torch.cuda.reset_peak_memory_stats()
    rng = torch.Generator('cuda').manual_seed(11)
    th.LAUNCHES.clear()
    tk.LAUNCHES.clear()
    pass_ms, cal_ms, run_ms = [], [], []
    for rep in range(4):        # a warm-up and 3 timed runs
        plot = trace_plot(128)
        entries.clear()
        runner.run_ray_tracing(plot, repeats=reps, run_process=run_process,
                               rng=rng)
        torch.cuda.synchronize()
        t = entries + [time.perf_counter()]
        if rep:
            cal_ms.append(1e3 * (t[1] - t[0]))
            pass_ms.append(statistics.median(
                1e3 * (b - a) for a, b in zip(t[1:-1], t[2:])))
            run_ms.append(1e3 * (t[-1] - t[0]))
    launches = dict(th.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(pass_ms)
    print(f'phase 6 trace: {n} rays/pass, float32, {reps} repeats + '
          f'calibration; calibration pass {statistics.median(cal_ms):.1f} '
          f'ms; pass median of 3 runs {med:.1f} ms '
          f'({", ".join(f"{v:.1f}" for v in pass_ms)}); '
          f'{n / (med * 1e-3):.3e} rays/s; whole run '
          f'{statistics.median(run_ms):.1f} ms; peak device memory '
          f'{peak / 2 ** 30:.2f} GiB', flush=True)
    good = plot.nRaysGood / plot.nRaysAll
    print(f'phase 6 plot: nRaysAll {plot.nRaysAll}, nRaysGood '
          f'{plot.nRaysGood} ({good:.6f}), intensity {plot.intensity:.6e}, '
          f'dx {plot.dx:.6f} mm, dy {plot.dy:.6f} mm, dE {plot.dE:.3f} eV; '
          f'launches of the 4 runs {launches}', flush=True)
    check(plot.nRaysAll == reps * n and plot.repeats == reps,
          f'trace: nRaysAll {plot.nRaysAll}, repeats {plot.repeats}')
    check(good > 0.9, f'trace: good fraction {good}')
    s2, s1 = float(plot.total2D.sum()), float(plot.total1D_x.sum())
    check(abs(s2 / s1 - 1) < 1e-5, f'trace: total2D {s2} vs total1D_x {s1}')
    check(math.isfinite(plot.intensity) and plot.intensity > 0,
          'trace: intensity not finite or zero')
    check(launches == {f'hist_plot:{th.plot_route((128,) * 3)}': 4 * reps},
          f'trace: not exactly one hist_plot launch per pass: {launches}')
    check(not tk.LAUNCHES, f'trace launched {dict(tk.LAUNCHES)}')

    # one pass by hand, split by CUDA events; the limits are the plot's
    ev = events(8)
    ev[0].record()
    beam = src.shine(rng)
    ev[1].record()
    glo, _ = tor.reflect(beam)
    ev[2].record()
    img = scr.expose(glo)
    ev[3].record()
    hists = runner.histogram_plot(plot, {'screen': img})
    ev[4].record()
    runner._accumulate(trace_plot(128), hists)
    ev[5].record()
    # the histogram step's two parts: the plot's arrays (getters, mask,
    # counters: eager torch) and the one hist_plot launch
    hp = events(3)
    hp[0].record()
    x, y, cData, inten, flux, mask, _ = runner._plot_arrays(
        plot, {'screen': img})
    hp[1].record()
    plot_args = (x, y, cData, flux, inten, mask,
                 (128, 128, 128), tuple(tuple(a.limits) for a in (
                     plot.xaxis, plot.yaxis, plot.caxis)),
                 plot.colorFactor, plot.colorSaturation)
    th.hist_plot_kernel(*plot_args)
    hp[2].record()
    lb = rotate_beam(global_to_virgin_local(beam, tor.center),
                     rotationSequence=tor.rotationSequence,
                     pitch=-tor.pitch, roll=-tor.roll, yaw=-tor.yaw)
    rays = (lb.x, lb.y, lb.z, lb.a, lb.b, lb.c)
    torch.cuda.synchronize()
    ev[6].record()
    evals = []      # the surface is evaluated at both bracket ends, once
                    # per Illinois iteration and in the two Newton steps

    def counted_z(xx, yy):
        evals.append(1)
        return tor.local_z(xx, yy)
    oebase.find_intersection(counted_z, *tor._bracket(*rays), *rays,
                             active=lb.state > 0)
    ev[7].record()
    torch.cuda.synchronize()
    ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(5)]
    print(f'phase 6 split of one pass (CUDA events): source {ms[0]:.1f} ms, '
          f'reflect {ms[1]:.1f} ms (bracket + search alone '
          f'{ev[6].elapsed_time(ev[7]):.1f} ms in {len(evals) - 4} Illinois '
          f'iterations), expose {ms[2]:.1f} ms, '
          f'histograms (one hist_plot launch) {ms[3]:.2f} ms, of which '
          f'_plot_arrays glue {hp[0].elapsed_time(hp[1]):.2f} ms and '
          f'hist_plot {hp[1].elapsed_time(hp[2]):.2f} ms, accumulate '
          f'{ms[4]:.1f} ms', flush=True)
    # the source with a CPU generator: float64 draws on the host, copied
    t0 = time.perf_counter()
    src.shine(torch.Generator().manual_seed(11))
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    print(f'phase 6 source sampling: CUDA generator {ms[0]:.1f} ms, CPU '
          f'generator (float64 draws on the host, copied) {host_ms:.1f} ms',
          flush=True)

    # a 1024 x 1024 plot: the 2D histograms take the device-memory route
    th.LAUNCHES.clear()
    big = trace_plot(1024)
    runner.run_ray_tracing(big, repeats=1, run_process=run_process, rng=rng)
    big_launches = dict(th.LAUNCHES)
    print(f'phase 6 1024-bin plot, 1 repeat: launches {big_launches}, '
          f'nRaysGood {big.nRaysGood}, intensity {big.intensity:.6e}',
          flush=True)
    check(big_launches == {f'hist_plot:{th.plot_route((1024,) * 3)}': 1},
          f'1024-bin plot: launches {big_launches}')
    check(abs(big.intensity / (plot.intensity / reps) - 1) < 1e-2,
          '1024-bin plot: intensity differs from the main run')
    fm = mask.to(x.dtype)
    big_args = plot_args[:6] + ((1024, 1024, 1024), tuple(
        tuple(a.limits) for a in (big.xaxis, big.yaxis, big.caxis))) + \
        plot_args[8:]
    timing['trace'] = dict(
        launches=launches, big_launches=big_launches, x=x, y=y,
        w=(inten * fm)[:, None].contiguous(),
        rgb=th.colorize(cData, torch.abs(flux * fm), plot.caxis.limits,
                        plot.colorFactor, plot.colorSaturation),
        xlim=tuple(plot.xaxis.limits), ylim=tuple(plot.yaxis.limits),
        xlim_big=tuple(big.xaxis.limits), ylim_big=tuple(big.yaxis.limits),
        plot_args={128: plot_args, 1024: big_args})


def phase_trace_cross():
    import torch
    res = {}
    for dt in (torch.float32, torch.float64):
        src, tor, scr = trace_beamline(200_000, dt)
        glo, _ = tor.reflect(src.shine(torch.Generator().manual_seed(21)))
        img = scr.expose(glo)
        good = img.state == 1
        w = torch.where(good, img.Jss + img.Jpp, 0.0).double()
        x, z = img.x.double(), img.z.double()
        cx, cz = (w * x).sum() / w.sum(), (w * z).sum() / w.sum()
        res[dt] = [float(v) for v in (
            good.double().mean(), w.sum(), cx, cz,
            torch.sqrt((w * (x - cx) ** 2).sum() / w.sum()),
            torch.sqrt((w * (z - cz) ** 2).sum() / w.sum()))]
    (g32, f32, cx32, cz32, sx32, sz32), (g64, f64, cx64, cz64, sx64, sz64) \
        = res[torch.float32], res[torch.float64]
    print(f'phase 7 trace float32 vs float64, 2e5 rays from the same '
          f'float64 samples: good fraction {g32:.6f} / {g64:.6f}, flux '
          f'ratio {f32 / f64:.6f}, centroid shift / size x '
          f'{abs(cx32 - cx64) / sx64:.2e} z {abs(cz32 - cz64) / sz64:.2e}, '
          f'size ratio x {sx32 / sx64:.6f} z {sz32 / sz64:.6f}', flush=True)
    check(abs(g32 - g64) < 1e-4, f'trace f32 vs f64: good {g32} / {g64}')
    check(abs(cx32 - cx64) < 1e-3 * sx64 and abs(cz32 - cz64) < 1e-3 * sz64,
          'trace f32 vs f64: centroids differ by more than 1e-3 sizes')
    check(abs(sx32 / sx64 - 1) < 1e-3 and abs(sz32 / sz64 - 1) < 1e-3,
          'trace f32 vs f64: sizes differ by more than 1e-3')
    # the float32 Fresnel amplitude near the critical angle is the known
    # weak spot of this beamline (see PERF.md): held to 5e-2 only
    check(abs(f32 / f64 - 1) < 5e-2, f'trace f32 vs f64 flux {f32 / f64}')


def hist_rows(timing):
    """The rows of the histogram kernel at the trace main path's shapes,
    on the rays of one of its passes: ``hist2d_kernel`` (its launches from
    the trace gradient, phase 12) and ``hist_plot`` (its launches from the
    trace runs, phase 6)."""
    import torch
    from xrt_tpu_torch import histogram as th
    tr = timing['trace']
    glaunch = timing['trace_grad_launches']
    rows = []
    specs = [('hist2d:k1', tr['w'], 128), ('hist2d:k3', tr['rgb'], 128),
             ('hist2d:k3:global', tr['rgb'], 1024)]
    for name, W, bins in specs:
        k = W.shape[1]
        big = bins == 1024
        args = (tr['x'], tr['y'], W, bins, bins,
                tr['xlim_big' if big else 'xlim'],
                tr['ylim_big' if big else 'ylim'])
        route = th.hist_route(bins, bins, k)
        kernel = lambda: th.hist2d_kernel(*args)
        kernel()
        torch.cuda.synchronize()
        ms = statistics.median(cuda_ms(kernel, 5)[0] for _ in range(3))
        got = kernel()
        plain_ms, _ = cuda_ms(lambda: th.hist2d_plain(*args))
        ref = th.hist2d_plain(*args, sum_dtype=torch.float64)
        rel, ab, same = hist_errors(got, ref)
        check(same, f'{name}: non-empty bins differ from the plain version')
        check(rel < 1e-4, f'{name} at main-path shapes: {rel:.3e}')
        # the library call: index_add_ on prepared indices and weights
        fx, inx = th._bin_index(args[0], args[5], bins)
        fy, iny = th._bin_index(args[1], args[6], bins)
        inside = inx & iny
        flat = torch.where(inside, fy * bins + fx,
                           torch.zeros_like(fx)).long()
        w = torch.where(inside[:, None], W, torch.zeros_like(W))

        def library():
            return torch.zeros((bins * bins, k), dtype=W.dtype,
                               device='cuda').index_add_(0, flat, w)
        library()
        lib_ms = statistics.median(cuda_ms(library, 3)[0] for _ in range(3))
        n = W.shape[0]
        bms = 1e3 * (4.0 * n * (2 + k) + 4.0 * bins * bins * k) / PEAK_BYTES
        key = f'hist2d:k{k}:{route}'
        print(f'phase 5 {name}: {n} rays into {bins} x {bins} x {k} '
              f'({route}), kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, '
              f'index_add_ {lib_ms:.4f} ms, bound {bms:.4f} ms (bytes), '
              f'{n / (ms * 1e-3):.3e} rays/s, max rel {rel:.2e}',
              flush=True)
        rows.append(dict(name=name, route='cuda', source=SOURCES['hist2d'],
                         replaces=REPLACES['hist2d'],
                         launches=int(glaunch.get(key, 0)),
                         max_abs_err=ab, max_rel_err=rel, ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, bound_by='bytes',
                         library_ms=lib_ms))
        check(rows[-1]['launches'] > 0, f'{name} was not launched on its '
              'path')
    for bins in (128, 1024):
        args = tr['plot_args'][bins]
        route = th.plot_route((bins,) * 3)
        kernel = lambda: th.hist_plot_kernel(*args)
        kernel()
        torch.cuda.synchronize()
        ms = statistics.median(cuda_ms(kernel, 5)[0] for _ in range(3))
        got = kernel()
        plain_ms, _ = cuda_ms(lambda: th.hist_plot_plain(*args))
        ref = th.hist_plot_plain(*args, sum_dtype=torch.float64)
        rel, same = plot_errors(got, ref)
        ab = max(float((got[k].double() - ref[k]).abs().max())
                 for k in th.PLOT_HISTS)
        check(same, f'hist_plot {bins}: bins differ from the plain version')
        check(rel < 1e-5, f'hist_plot {bins} at main-path shapes: {rel:.3e}')
        # the step it replaces: colorize and eight hist2d_kernel launches
        x, y, c, flux, w2d, mask, _, (xl, yl, cl), cf, sat = args

        def eight():
            fm = mask.to(x.dtype)
            af = torch.abs(flux * fm)
            rgb = th.colorize(c, af, cl, cf, sat)
            w2 = (w2d * fm)[:, None]
            return [th.hist2d_kernel(v, None, wv, bins, 1, lim)
                    for v, lim in ((x, xl), (y, yl), (c, cl))
                    for wv in (af[:, None], rgb)] + [
                th.hist2d_kernel(x, y, w2, bins, bins, xl, yl),
                th.hist2d_kernel(x, y, rgb, bins, bins, xl, yl)]
        eight()
        eight_ms = statistics.median(cuda_ms(eight, 3)[0] for _ in range(3))
        n = x.shape[0]
        nout = 4 * (3 * bins + bins * bins) + 1
        bms = 1e3 * (21.0 * n + 4.0 * nout) / PEAK_BYTES
        key = f'hist_plot:{route}'
        launches = tr['launches' if bins == 128 else 'big_launches']
        print(f'phase 5 hist_plot {bins} bins: {n} rays into eight '
              f'histograms ({route}), kernel {ms:.4f} ms, plain '
              f'{plain_ms:.2f} ms, library none (colorize and eight '
              f'hist2d_kernel launches: {eight_ms:.4f} ms), bound '
              f'{bms:.4f} ms (bytes), {n / (ms * 1e-3):.3e} rays/s, max rel '
              f'{rel:.2e}', flush=True)
        rows.append(dict(name=f'hist_plot:{bins}', route='cuda',
                         source=SOURCES['hist_plot'],
                         replaces=REPLACES['hist_plot'],
                         launches=int(launches.get(key, 0)),
                         max_abs_err=ab, max_rel_err=rel, ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, bound_by='bytes',
                         library_ms=None, eight_launches_ms=eight_ms))
        check(rows[-1]['launches'] > 0, f'hist_plot {bins} was not launched '
              'on its path')
    return rows


# ---------------------------------------------------------------------------
# the gradient slice: the adjoint kernels (B3, B4-bwd) and their paths
# ---------------------------------------------------------------------------

def launch_adjoint(scheme, v, D, S, P, G):
    from xrt_tpu_torch.ops import kirchhoff as tk
    if scheme == 'recentred':
        return tk._launch_recentred_bwd(D, S, P, G, v)
    return tk._launch_ddphase_bwd(D, S, G, v) + (None,)


def row_errors(got, ref):
    """(max over rows of max|row - ref| / max|ref|, max abs difference)."""
    rel, ab = 0.0, 0.0
    for i in range(ref.shape[0]):
        d = float((got[i] - ref[i]).abs().max())
        scale = float(ref[i].abs().max())
        rel = max(rel, d / scale if scale > 0 else (math.inf if d else 0.0))
        ab = max(ab, d)
    return rel, ab


def phase_adjoint_kernels(timing):
    import torch
    from xrt_tpu_torch import histogram as th
    from xrt_tpu_torch.ops import kirchhoff as tk
    plain_ms_of = {}
    for mode in ('mono', 'narrowband', 'poly', 'fast', 'exact'):
        args = kernel_case_args('mono' if mode == 'mono' else 'poly')
        scheme, v, D, S, P = tk._kernel_inputs(*args, mode)
        Nd, Ns = D.shape[1], S.shape[1]
        G = torch.randn((10, Nd), device='cuda',
                        generator=torch.Generator('cuda').manual_seed(7))
        got = launch_adjoint(scheme, v, D, tk._pad_sources(S), P, G)
        again = launch_adjoint(scheme, v, D, tk._pad_sources(S), P, G)
        torch.cuda.synchronize()
        same = all(a is None or torch.equal(a, b) for a, b in zip(got, again))
        check(same, f'B3 {mode}: two launches on the same inputs differ')
        if mode == 'mono':      # warm-up
            tk.kirchhoff_bwd_blocked(scheme, v, D, S, P, G)
        plain_ms, ref = cuda_ms(lambda: tk.kirchhoff_bwd_blocked(
            scheme, v, D, S, P, G))
        check(all(bool(torch.isfinite(t).all()) for t in got
                  if t is not None), f'B3 {mode}: non-finite cotangents')
        relD = row_errors(got[0], ref[0])[0]
        relS = row_errors(got[1][:, :Ns], ref[1])[0]
        relP = 0.0 if ref[2] is None else \
            row_errors(got[2][:, None], ref[2][:, None])[0]
        ms = statistics.median(cuda_ms(lambda: launch_adjoint(
            scheme, v, D, tk._pad_sources(S), P, G))[0] for _ in range(3))
        print(f'phase 8 B3 {mode}: {Nd} x {Ns}, kernel vs plain blocked '
              f'backward, max row rel: dst keys {relD:.2e}, src keys '
              f'{relS:.2e}, scalars {relP:.2e} (limit {ADJ_LIMIT:.0e}); '
              f'two launches bit-identical; kernel {ms:.2f} ms, plain '
              f'{plain_ms:.1f} ms', flush=True)
        check(max(relD, relS, relP) < ADJ_LIMIT,
              f'B3 {mode}: {relD:.3e} / {relS:.3e} / {relP:.3e}')
        plain_ms_of[mode] = plain_ms
    timing['adjoint_plain_ms'] = plain_ms_of

    for case in ('shared', 'global', '1d', 'special', 'ragged'):
        for k in (1, 3):
            x, y, _, xbins, ybins, xlim, ylim = hist_case(case, k)
            g = torch.rand((ybins, xbins, k), device='cuda',
                           generator=torch.Generator('cuda').manual_seed(k))
            got = th.hist2d_bwd_kernel(x, y, g, xbins, ybins, xlim, ylim)
            torch.cuda.synchronize()
            same = torch.equal(got, th.hist2d_bwd_plain(x, y, g, xbins,
                                                        ybins, xlim, ylim))
            print(f'phase 8 B4-bwd {case} k={k}: {x.shape[0]} rays from '
                  f'{ybins} x {xbins}, kernel vs advanced indexing '
                  f'{"equal" if same else "DIFFER"}', flush=True)
            check(same, f'B4-bwd {case} k={k} differs from indexing')
    # the scalar path (views one ray into their storage: 4-byte, not
    # 16-byte, aligned), ray counts 1 to 7 (the scalar tail) and float64
    x, y, _, xbins, ybins, xlim, ylim = hist_case('ragged', 3)
    for k in (1, 3):
        g = torch.rand((ybins, xbins, k), device='cuda',
                       generator=torch.Generator('cuda').manual_seed(k))
        cases = [(x[1:], y[1:], g), (x.double(), y.double(), g.double())] + \
            [(x[:m], y[:m], g) for m in range(1, 8)]
        for xx, yy, gg in cases:
            got = th.hist2d_bwd_kernel(xx, yy, gg, xbins, ybins, xlim, ylim)
            check(torch.equal(got, th.hist2d_bwd_plain(
                xx, yy, gg, xbins, ybins, xlim, ylim)),
                f'B4-bwd k={k}: {xx.shape[0]} rays of {xx.dtype} at offset '
                f'{xx.storage_offset()} differ from indexing')
        print(f'phase 8 B4-bwd k={k}: views at a 4-byte offset, 1 to 7 rays '
              f'and float64 equal to advanced indexing', flush=True)


def sweep_plain_blocks():
    """Times and peak memory of the plain blocked backward (recentred mono,
    8192 x 16384) for four (destination block, source chunk) sizes."""
    import torch
    from xrt_tpu_torch.ops import kirchhoff as tk
    scheme, v, D, S, P = tk._kernel_inputs(*kernel_case_args('mono'), 'mono')
    G = torch.randn((10, D.shape[1]), device='cuda',
                    generator=torch.Generator('cuda').manual_seed(7))
    tk.kirchhoff_bwd_blocked(scheme, v, D, S, P, G)      # warm-up
    for blk, chunk in ((2048, 512), (4096, 1024), (8192, 512), (8192, 2048)):
        torch.cuda.reset_peak_memory_stats()
        ms, _ = cuda_ms(lambda: tk.kirchhoff_bwd_blocked(
            scheme, v, D, S, P, G, blk, chunk))
        print(f'plain blocked backward, recentred mono, {D.shape[1]} x '
              f'{S.shape[1]}: blocks of {blk} x {chunk} {ms:.1f} ms, peak '
              f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB',
              flush=True)


@contextlib.contextmanager
def plain_recentred_adjoint():
    """Within the block, the backward of the recentred autograd function
    runs the plain blocked backward where it launches its adjoint kernels
    (on the same padded sources: zero weights and fields, cotangents that
    the function drops).  The reference of a gradient on the card.  Yields
    a dict that takes the plain backward's time in ms by destination
    count."""
    from xrt_tpu_torch.ops import kirchhoff as tk
    kernel = tk._launch_recentred_bwd
    times = {}

    def plain(D, S, P, G, v):
        times[D.shape[1]], out = cuda_ms(lambda: tk.kirchhoff_bwd_blocked(
            'recentred', v, D, S, P, G))
        return out
    tk._launch_recentred_bwd = plain
    try:
        yield times
    finally:
        tk._launch_recentred_bwd = kernel


def grad_context(run, els):
    """What the gradient of the chain needs beside its build: the
    linearized-retargeting Jacobians (host float64, exact transforms) of
    the toroid's receiving samples and of the screen's samples with
    respect to the toroid's pitch, the direction of a surface-height offset
    in the slit's frame with its profile (y / 40 mm)^2 along the mirror,
    and the loss weight (a Gaussian window off the screen's centre, so
    that no gradient vanishes by symmetry)."""
    import numpy as np
    import torch
    from xrt_tpu_torch import waves as W
    src, slit, tor, scr = els
    wv0, wv1, wv2 = run.waves
    dt = wv1.x.dtype

    def h64(t):
        return t.detach().double().cpu().numpy()

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device='cuda')
    J1 = dev(W._placement_jacobian(tor, slit, h64(wv1.x), h64(wv1.y),
                                   h64(wv1.z)))
    J2 = dev(W._placement_jacobian(scr, tor, h64(wv2.x), h64(wv2.y),
                                   h64(wv2.z), vary='from'))
    R1 = W.wave_frame_rotation(tor, slit)
    wgt = torch.exp(-(wv2.x ** 2 + (wv2.z - 0.004) ** 2) / 0.006 ** 2)
    return dict(J1=J1, J2=J2, R1=[float(v) for v in R1[:, 2]], wgt=wgt,
                profile=(wv1.y / 40.0) ** 2)


def chain_loss(run, els, ctx, w0, dp, dz, timings=None):
    """The Gaussian-weighted focal flux of the chain as a function of the
    source waist *w0*, the toroid's pitch offset *dp* and the amplitude
    *dz* of the height profile of its surface samples, through
    ``WaveChain.run``."""
    import torch
    src, slit, tor, scr = els
    wv0, wv1, wv2 = run.waves
    J1, J2, R1 = ctx['J1'], ctx['J2'], ctx['R1']
    tor_t = tor.replace(pitch=tor.pitch + dp)
    dz = dz * ctx['profile']
    a = wv0.replace(fromOE=src.replace(w0=w0))
    b = wv1.replace(xDiffr=wv1.xDiffr + J1[0] * dp + R1[0] * dz,
                    yDiffr=wv1.yDiffr + J1[1] * dp + R1[1] * dz,
                    zDiffr=wv1.zDiffr + J1[2] * dp + R1[2] * dz,
                    z=wv1.z + dz, toOE=tor_t)
    c = wv2.replace(xDiffr=wv2.xDiffr + J2[0] * dp,
                    yDiffr=wv2.yDiffr + J2[1] * dp,
                    zDiffr=wv2.zDiffr + J2[2] * dp, fromOE=tor_t)
    out, logs = run(torch.Generator().manual_seed(2), timings=timings,
                    waves=(a, b, c))
    flux = ((out.Jss + out.Jpp) * ctx['wgt']).double().sum()
    return flux * torch.exp(-2.0 * logs.double())


#: the working point of the gradients: (w0 mm, pitch offset rad, height
#: amplitude mm)
GRAD_POINT = (0.05, 0.0, 0.0)
GRAD_NAMES = ('w0', 'pitch offset', 'height amplitude')


def grad_leaves(dtype, point=GRAD_POINT):
    import torch
    return [torch.tensor(v, dtype=dtype, device='cuda', requires_grad=True)
            for v in point]


def phase_grad_main(timing):
    import torch
    from xrt_tpu_torch.ops import kirchhoff as tk
    main = timing['main']
    run, els = main['run'], main['els']
    t0 = time.perf_counter()
    ctx = grad_context(run, els)
    t_ctx = time.perf_counter() - t0

    def step():
        leaves = grad_leaves(torch.float32)
        loss = chain_loss(run, els, ctx, *leaves)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return loss, grads
    step()      # warm-up
    torch.cuda.reset_peak_memory_stats()
    tk.LAUNCHES.clear()
    t0 = time.perf_counter()
    loss, grads = step()
    times = [time.perf_counter() - t0]
    launches = dict(tk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for _ in range(2):
        t0 = time.perf_counter()
        loss, grads = step()
        times.append(time.perf_counter() - t0)
    fwd = []
    for _ in range(3):
        t0 = time.perf_counter()
        with torch.no_grad():
            chain_loss(run, els, ctx, *grad_leaves(torch.float32))
        torch.cuda.synchronize()
        fwd.append(time.perf_counter() - t0)
    med, medf = statistics.median(times), statistics.median(fwd)
    vals = [float(g) for g in grads]
    tk.LAUNCHES.clear()
    t0 = time.perf_counter()
    with plain_recentred_adjoint() as plain_ms:
        ref = [float(g) for g in step()[1]]
    t_ref = time.perf_counter() - t0
    ref_launches = dict(tk.LAUNCHES)
    errs = [abs(a / b - 1) for a, b in zip(vals, ref)]
    print(f'phase 9 gradient main path: 200000 samples/wave, 256x256 screen, '
          f'float32; loss {float(loss.detach()):.6e}; gradients '
          f'{dict(zip(GRAD_NAMES, vals))}; forward + backward median of 3 '
          f'{med * 1e3:.1f} ms ({", ".join(f"{t * 1e3:.1f}" for t in times)}'
          f'), forward alone {medf * 1e3:.1f} ms '
          f'({", ".join(f"{t * 1e3:.1f}" for t in fwd)}), ratio '
          f'{med / medf:.2f}; {sum(main["pairs"]) / med:.3e} pairs/s; '
          f'retargeting Jacobians (host) {t_ctx:.2f} s; peak device memory '
          f'{peak / 2 ** 30:.2f} GiB; launches of one step {launches}',
          flush=True)
    print(f'phase 9 the same step with the plain blocked backward in place '
          f'of the adjoint kernels ({t_ref:.1f} s, launches {ref_launches}; '
          f'plain backward by destinations, ms: '
          f'{ {n: round(t, 1) for n, t in plain_ms.items()} }): '
          f'gradients {dict(zip(GRAD_NAMES, ref))}; kernels vs plain '
          f'{", ".join(f"{e:.2e}" for e in errs)} (limit '
          f'{GRAD_PLAIN_LIMIT:.0e})', flush=True)
    check(all(math.isfinite(v) and v != 0.0 for v in vals) and
          math.isfinite(float(loss.detach())),
          f'gradient main path: loss {float(loss.detach())}, gradients '
          f'{vals}')
    check(ref_launches == {'kirchhoff_recentred:mono': 2},
          f'plain-backward step: launches {ref_launches}')
    check(max(errs) < GRAD_PLAIN_LIMIT,
          f'gradient main path, kernels vs plain backward: {errs}')
    check(launches == {'kirchhoff_recentred:mono': 2,
                       'kirchhoff_recentred_bwd:mono': 2},
          f'gradient main path: launches {launches}')
    timing['grad_launches'] = launches
    timing['grad_plain_ms'] = plain_ms


def phase_grad_cross():
    import torch
    res = {}
    for dt in (torch.float32, torch.float64):
        run, els = build_chain(20_000, 64, dt, seed=4)
        ctx = grad_context(run, els)
        leaves = grad_leaves(dt)
        loss = chain_loss(run, els, ctx, *leaves)
        res[dt] = (float(loss.detach()), [float(g) for g in
                                 torch.autograd.grad(loss, leaves)])
        if dt == torch.float64:
            # four-point central differences: the steps sit between the
            # float64 phase rounding (one ulp of r is ~2e-6 rad at
            # k r = 1.3e10), which a smaller step amplifies, and the
            # curvature of the loss, whose h^2 term the stencil cancels
            fds = []
            for i, h in enumerate((1e-5, 3e-8, 4e-6)):
                f = {}
                for m in (-2, -1, 1, 2):
                    pt = list(GRAD_POINT)
                    pt[i] += m * h
                    with torch.no_grad():
                        f[m] = float(chain_loss(
                            run, els, ctx, *[torch.tensor(
                                v, dtype=dt, device='cuda') for v in pt]))
                fds.append((f[-2] - 8 * f[-1] + 8 * f[1] - f[2]) / (12 * h))
    (l32, g32), (l64, g64) = res[torch.float32], res[torch.float64]
    print(f'phase 10 gradient cross-check, 2e4 samples, 64x64 screen: loss '
          f'float32 {l32:.6e} float64 {l64:.6e}', flush=True)
    for name, a, b, fd in zip(GRAD_NAMES, g32, g64, fds):
        e32, efd = abs(a / b - 1), abs(b / fd - 1)
        print(f'phase 10 d/d({name}): float32 kernels {a:.6e}, float64 '
              f'plain {b:.6e}, finite difference {fd:.6e}; float32 vs '
              f'float64 {e32:.2e} (limit 3e-2), float64 vs FD {efd:.2e} '
              f'(limit 1e-3)', flush=True)
        check(e32 < 3e-2, f'gradient {name}: float32 vs float64 {e32:.3e}')
        check(efd < 1e-3, f'gradient {name}: float64 vs FD {efd:.3e}')


def phase_grad_b2(timing):
    """The toroid -> screen hop at full size: the gradient of the weighted
    flux with respect to a shift of the screen samples along the
    retargeting direction (destination cotangents) and to the amplitude of
    the height profile of the source samples (source cotangents), B2's
    adjoint against B1's."""
    import torch
    from xrt_tpu_torch import waves as W
    from xrt_tpu_torch.ops import kirchhoff as tk
    main = timing['main']
    ctx = grad_context(main['run'], main['els'])
    oeLocal, wave = timing['stages'][1]
    J2, wgt = ctx['J2'], ctx['wgt']
    res, launches = {}, {}
    for pm in ('recentred', 'fast', 'exact'):
        dp, dz = grad_leaves(torch.float32, (0.0, 0.0))
        tk.LAUNCHES.clear()
        t0 = time.perf_counter()
        out = W.diffract(
            oeLocal.replace(z=oeLocal.z + dz * ctx['profile']),
            wave.replace(xDiffr=wave.xDiffr + J2[0] * dp,
                         yDiffr=wave.yDiffr + J2[1] * dp,
                         zDiffr=wave.zDiffr + J2[2] * dp),
            phase_mode=pm, monochromatic=True, accumulate='mxu-fast',
            narrowband=False)
        loss = ((out.Jss + out.Jpp) * wgt).double().sum()
        grads = torch.autograd.grad(loss, [dp, dz])
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        launches[pm] = dict(tk.LAUNCHES)
        res[pm] = [float(loss.detach())] + [float(g) for g in grads]
        print(f'phase 11 toroid -> screen hop, {pm}: loss {res[pm][0]:.6e}, '
              f'd/d(pitch shift) {res[pm][1]:.6e}, d/d(height) '
              f'{res[pm][2]:.6e}; forward + backward {t * 1e3:.1f} ms; '
              f'launches {launches[pm]}', flush=True)
    for pm in ('fast', 'exact'):
        errs = [abs(a / b - 1) for a, b in zip(res[pm][1:],
                                               res['recentred'][1:])]
        print(f'phase 11 B2 {pm} gradient vs recentred: '
              f'{", ".join(f"{e:.2e}" for e in errs)} (limit 3e-2)',
              flush=True)
        check(max(errs) < 3e-2, f'B2 {pm} gradient vs recentred: {errs}')
        check(launches[pm] == {f'kirchhoff_ddphase:{pm}': 1,
                               f'kirchhoff_ddphase_bwd:{pm}': 1},
              f'B2 {pm} gradient: launches {launches[pm]}')
    timing['b2_grad_launches'] = {k: v for d in launches.values()
                                  for k, v in d.items()}


def trace_flux(src, tor, scr, beam, pitch, bins=128, rgb=False):
    """The weighted central flux on the screen through toroid (with the
    search) -> screen -> hist2d, as a function of the toroid's pitch: the
    loss of the reference package's trace-gradient test (a smooth central
    weight over +-2 mm, not a hard pixel edge).  The histogram passes a
    gradient to the weights only, so a finite difference also sees rays
    that change bins; the broad symmetric weight keeps that part small.
    With *rgb* the histogram has the three weight columns of a colour plot,
    here Jss, Jpp and their sum, all summed: twice the flux."""
    import torch
    from xrt_tpu_torch.histogram import hist2d, hist2d_rgb
    glo, _ = tor.replace(pitch=pitch).reflect(beam)
    img = scr.expose(glo)
    lim = (-2.0, 2.0)
    if rgb:
        good = (img.state == 1)[:, None]
        w = torch.stack([img.Jss, img.Jpp, img.Jss + img.Jpp], dim=1)
        h = hist2d_rgb(img.x, img.z, torch.where(good, w, 0.0), bins, bins,
                       lim, lim).sum(dim=-1)
    else:
        w = torch.where(img.state == 1, img.Jss + img.Jpp, 0.0)
        h = hist2d(img.x, img.z, w, bins, bins, lim, lim)
    c = torch.linspace(-2, 2, bins, dtype=w.dtype, device=w.device)
    wz = torch.exp(-c ** 2 / 0.5)
    return torch.sum(h * wz[:, None] * wz[None, :])


def phase_trace_grad(timing):
    import torch
    from xrt_tpu_torch import histogram as th
    n = TRACE_NRAYS
    src, tor, scr = trace_beamline(n, torch.float32)
    rng = torch.Generator('cuda').manual_seed(31)

    def step(beam, rgb=False, bins=128):
        pitch = torch.tensor(TRACE_PITCH, device='cuda', requires_grad=True)
        flux = trace_flux(src, tor, scr, beam, pitch, bins=bins, rgb=rgb)
        g, = torch.autograd.grad(flux, [pitch])
        torch.cuda.synchronize()
        return float(flux.detach()), float(g)
    beam = src.shine(rng)
    step(beam)      # warm-up
    torch.cuda.reset_peak_memory_stats()
    th.LAUNCHES.clear()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        flux, g = step(beam)
        times.append(time.perf_counter() - t0)
    launches = dict(th.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    fwd = []
    for _ in range(3):
        t0 = time.perf_counter()
        with torch.no_grad():
            trace_flux(src, tor, scr, beam, torch.tensor(TRACE_PITCH,
                                                         device='cuda'))
        torch.cuda.synchronize()
        fwd.append(time.perf_counter() - t0)
    med, medf = statistics.median(times), statistics.median(fwd)
    print(f'phase 12 trace gradient: {n} rays, float32, d(weighted central '
          f'flux)/d(pitch) {g:.6e} (flux {flux:.6e}); reflect + expose + '
          f'hist2d forward + backward median of 3 {med * 1e3:.1f} ms '
          f'({", ".join(f"{t * 1e3:.1f}" for t in times)}), forward alone '
          f'{medf * 1e3:.1f} ms; peak device memory {peak / 2 ** 30:.2f} '
          f'GiB; launches of the 3 steps {launches}', flush=True)
    check(math.isfinite(g) and g != 0.0, f'trace gradient {g}')
    check(launches == {f'hist2d:k1:{th.hist_route(128, 128, 1)}': 3,
                       'hist2d_bwd:k1': 3},
          f'trace gradient: launches {launches}')
    th.LAUNCHES.clear()
    flux3, g3 = step(beam, rgb=True)
    launches3 = dict(th.LAUNCHES)
    print(f'phase 12 trace gradient through the three-column histogram: '
          f'flux {flux3:.6e}, gradient {g3:.6e}; against twice the '
          f'one-column flux and gradient {abs(flux3 / (2 * flux) - 1):.2e}, '
          f'{abs(g3 / (2 * g) - 1):.2e} (limit 1e-4); launches {launches3}',
          flush=True)
    check(abs(flux3 / (2 * flux) - 1) < 1e-4 and abs(g3 / (2 * g) - 1) < 1e-4,
          f'three-column trace gradient {g3} against 2 x {g}')
    check(launches3 == {f'hist2d:k3:{th.hist_route(128, 128, 3)}': 1,
                        'hist2d_bwd:k3': 1},
          f'three-column trace gradient: launches {launches3}')
    # the same at 1024 x 1024 bins: the table in device memory
    th.LAUNCHES.clear()
    flux_big, g_big = step(beam, rgb=True, bins=1024)
    launches_big = dict(th.LAUNCHES)
    print(f'phase 12 trace gradient through the three-column histogram at '
          f'1024 x 1024 bins: flux {flux_big:.6e}, gradient {g_big:.6e}; '
          f'launches {launches_big}', flush=True)
    check(math.isfinite(g_big) and g_big != 0.0 and
          abs(flux_big / flux3 - 1) < 1e-2,
          f'1024-bin trace gradient {g_big}, flux {flux_big} vs {flux3}')
    check(launches_big == {f'hist2d:k3:{th.hist_route(1024, 1024, 3)}': 1,
                           'hist2d_bwd:k3': 1},
          f'1024-bin trace gradient: launches {launches_big}')
    timing['trace_grad_launches'] = {**launches, **launches3, **launches_big}

    res = {}
    for dt in (torch.float32, torch.float64):
        src, tor, scr = trace_beamline(200_000, dt)
        beam = src.shine(torch.Generator().manual_seed(21))
        pitch = torch.tensor(TRACE_PITCH, dtype=dt, device='cuda',
                             requires_grad=True)
        flux = trace_flux(src, tor, scr, beam, pitch, bins=16)
        res[dt], = torch.autograd.grad(flux, [pitch])
        if dt == torch.float64:
            h = 2e-6
            with torch.no_grad():
                fd = (float(trace_flux(src, tor, scr, beam, torch.tensor(
                    TRACE_PITCH + h, dtype=dt, device='cuda'), bins=16)) -
                    float(trace_flux(src, tor, scr, beam, torch.tensor(
                        TRACE_PITCH - h, dtype=dt, device='cuda'),
                        bins=16))) / (2 * h)
    g32, g64 = float(res[torch.float32]), float(res[torch.float64])
    print(f'phase 12 trace gradient at 2e5 rays, 16 x 16 bins, the same '
          f'float64 samples: float32 {g32:.6e}, float64 {g64:.6e}, finite '
          f'difference {fd:.6e}; float32 vs float64 {abs(g32 / g64 - 1):.2e}'
          f', float64 vs FD {abs(g64 / fd - 1):.2e} (limits 0.1)',
          flush=True)
    check(abs(g32 / g64 - 1) < 0.1, f'trace gradient f32 {g32} f64 {g64}')
    check(abs(g64 / fd - 1) < 0.1, f'trace gradient f64 {g64} FD {fd}')


def port_tool(name):
    """A module of tools/ (imported from the checkout this script lies
    in)."""
    import importlib
    import os
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), 'tools'))
    return importlib.import_module(name)


def overlap(a, b):
    import numpy as np
    a = np.asarray(a, np.complex128)
    b = np.asarray(b, np.complex128)
    na, nb = np.vdot(a, a).real, np.vdot(b, b).real
    return abs(np.vdot(a, b)) / math.sqrt(na * nb) if na > 0 and nb > 0 \
        else 0.0


def phase_softimax(timing):
    """Phase 13: the SoftiMAX chain at 2e5 samples per wave, tiled, in
    float32 on the card."""
    import numpy as np
    import torch
    from xrt_tpu_torch import waves as W
    from xrt_tpu_torch.ops import kirchhoff as tk
    bs = port_tool('torch_bench_softimax')
    n, nscr = SX_NRAYS, SX_NSCR
    t0 = time.perf_counter()
    rc = bs.build_chain(nrays=n, n_scr=nscr, tiled=True,
                        dtype=torch.float32, device='cuda')
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    print(f'phase 13 SoftiMAX build: {n} samples/wave, {nscr}x{nscr} focal '
          f'images, float32, tiled; {t_build:.2f} s', flush=True)
    for name, mode in rc.modes.items():
        tm = rc.tilemaps.get(name)
        tiles = f', tiled 5 x 10: {W.tile_pairs_by_mode(tm)}' if tm else ''
        print(f'phase 13 stage {name}: {mode}{tiles}', flush=True)
    n_fast = sum(W.tile_pairs_by_mode(tm).get(('fast', 'vpu'), 0)
                 for tm in rc.tilemaps.values())
    check(W.tile_pairs_by_mode(rc.tilemaps.get('pg') or []).get(
        ('fast', 'vpu'), 0) > 0, 'SoftiMAX: no tile pair of M2 -> PG runs B2')
    # the main path: one run, its launches counted
    inputs = {}
    tk.LAUNCHES.clear()
    imgs = rc(torch.Generator().manual_seed(3), inputs=inputs)
    torch.cuda.synchronize()
    launches = dict(tk.LAUNCHES)
    times, timings = [], []
    torch.cuda.reset_peak_memory_stats()
    for rep in range(3):
        t0 = time.perf_counter()
        imgs = rc(torch.Generator().manual_seed(3),
                  timings=timings if rep == 2 else None)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times)
    pairs = 7 * n * n + 3 * n * nscr * nscr
    for rec in timings:
        ms = rec['start'].elapsed_time(rec['end'])
        tiles = f", tile pairs {rec['tiles']}" if 'tiles' in rec else ''
        print(f"phase 13 {rec['stage']}: {rec['mode']}{tiles}, {ms:.2f} ms "
              f'(CUDA events, last timed run)', flush=True)
    n_tiled = sum(len(tm) * len(tm[0]) for tm in rc.tilemaps.values())
    n_untiled = len(rc.modes) - len(rc.tilemaps)
    print(f'phase 13 SoftiMAX chain: median of 3 {med * 1e3:.1f} ms '
          f'({", ".join(f"{t * 1e3:.1f}" for t in times)}); '
          f'{pairs:.4e} pairs, {pairs / med:.3e} pairs/s; peak memory '
          f'{peak / 2 ** 30:.3f} GiB; launches of one run {launches}',
          flush=True)
    check(launches.get('kirchhoff_ddphase:fast', 0) == n_fast,
          f'SoftiMAX: B2 launches {launches} != {n_fast} contact tiles')
    check(launches.get('kirchhoff_recentred:mono', 0) ==
          n_untiled + n_tiled - n_fast,
          f'SoftiMAX: B1 launches {launches}')
    for i, dq in enumerate(bs.D_FOCUS):
        tot, pk = float(imgs[i].sum()), float(imgs[i].max())
        print(f'phase 13 focus {dq:+.0f} mm: total {tot:.6e}, peak '
              f'{pk:.6e}', flush=True)
        check(np.all(np.isfinite(imgs[i])) and tot > 0 and pk > 0,
              f'SoftiMAX focal image {i} not finite and positive')
    # the first contact tile of M2 -> PG through B2 and its plain version,
    # and the first recentred tile through B1 and its plain version
    args = W.kirchhoff_kernel_args(inputs['pg'], rc.waves['pg'])
    firsts = {}
    for ij, (pm, _), pair, _ in W.tile_pair_args(args, rc.tilemaps['pg']):
        firsts.setdefault(pm, (ij, pair))
    rows = []
    for pm, name, variant in (('fast', 'kirchhoff_ddphase', 'fast'),
                              ('recentred', 'kirchhoff_recentred', 'mono')):
        ij, pair = firsts[pm]
        call = lambda: tk.kirchhoff_integral_kernel(  # noqa: E731
            *pair, phase_mode=pm, monochromatic=True, accumulate='vpu',
            narrowband=False, check_envelope=False)
        call()
        torch.cuda.synchronize()
        call_ms = statistics.median(cuda_ms(call)[0] for _ in range(3))
        ms, plain_ms, ab, rel, Nd, Ns, ex = time_kernel(name, variant,
                                                        list(pair))
        key = f'{name}:{variant}'
        bms, by = bound_ms(key, Nd, Ns)
        print(f'phase 13 M2 -> PG tile pair {ij} ({pm}): {Nd} x {Ns} '
              f'pairs, kernel {ms:.3f} ms, the whole call (per-point '
              f'preparation and kernel) {call_ms:.3f} ms, plain '
              f'{plain_ms:.2f} ms, bound {bms:.3f} ms ({by}), '
              f'{bms / ms:.1%} of bound, max rel {rel:.2e} (limit 2e-5)',
              flush=True)
        check(rel < 2e-5, f'SoftiMAX {key} tile {ij}: {rel:.3e}')
        rows.append(dict(name=f'{key}:softimax-tile', route='cuda',
                         source=SOURCES[name], replaces=REPLACES[name],
                         launches=int(launches.get(key, 0)),
                         max_abs_err=ab, max_rel_err=rel, ms=ms,
                         call_ms=call_ms, plain_ms=plain_ms, bound_ms=bms,
                         bound_by=by, library_ms=None,
                         shape=f'{Nd}x{Ns}'))
    timing['softimax_rows'] = rows
    timing['softimax_chain'] = (rc, inputs)
    shine = [r for r in timings if r['stage'] == 'shine']
    print(f"phase 13 undulator shine_wave: "
          f"{shine[0]['start'].elapsed_time(shine[0]['end']):.2f} ms "
          f'(CUDA events), plain PyTorch', flush=True)


def phase_softimax_cross():
    """Phase 14: the SoftiMAX cross-checks on the card."""
    import os
    import numpy as np
    import torch
    from xrt_tpu_torch import waves as W
    bs = port_tool('torch_bench_softimax')
    # 1. the undulator field, float32 against float64 on the same samples
    el32 = bs.beamline(torch.float32, 'cuda')
    w32 = W.prepare_wave_on_aperture(el32['slitFE'], el32['src'], SX_NRAYS,
                                     generator=torch.Generator().manual_seed(
                                         5), dtype=torch.float32,
                                     device='cuda')
    w64 = W.prepare_wave_on_aperture(el32['slitFE'], el32['src'], 0,
                                     samples=(w32.x.double(), w32.z.double()),
                                     dtype=torch.float64, device='cuda')
    e32 = el32['src'].shine_wave(None, w32, bs.E0).Es.cpu().numpy()
    e64 = el32['src'].shine_wave(None, w64, bs.E0).Es.cpu().numpy()
    amp = np.abs(e32).mean() / np.abs(e64).mean()
    ov = overlap(e64, e32)
    print(f'phase 14 undulator shine_wave at {SX_NRAYS} samples, float32 vs '
          f'float64: amplitude ratio {amp:.8f} (limit 1 +- 1e-3), overlap '
          f'{ov:.8f} (limit 0.999)', flush=True)
    check(abs(amp - 1) < 1e-3 and ov > 0.999,
          f'undulator f32 vs f64: amplitude {amp}, overlap {ov}')
    # 2. tiled against untiled on the M1 -> M2 stage, samples sorted by y
    rc = bs.build_chain(nrays=SX_TILE_NRAYS, n_scr=16, tiled=True,
                        dtype=torch.float32, device='cuda')
    inputs = {}
    rc(inputs=inputs)
    cur, wm2 = inputs['m2'], rc.waves['m2']
    tm = rc.tilemaps.get('m2') or W.choose_tile_modes(
        (wm2.xDiffr, wm2.yDiffr, wm2.zDiffr), (cur.x, cur.y, cur.z), 5, 10)
    pm, acc = rc.modes['m2']
    un = W.diffract(cur, wm2, phase_mode=pm, accumulate=acc,
                    monochromatic=True, narrowband=False).Es
    ti = W.diffract(cur, wm2, monochromatic=True, tile_modes=tm,
                    narrowband=False).Es
    err = float((ti - un).abs().max() / un.abs().max())
    print(f'phase 14 M1 -> M2 at {SX_TILE_NRAYS} samples, tiled 5 x 10 '
          f'{W.tile_pairs_by_mode(tm)} vs untiled {(pm, acc)}: '
          f'max|dEs|/max|Es| {err:.3e} (limit 0.02)', flush=True)
    check(err <= 0.02, f'tiled vs untiled M1 -> M2: {err:.3e}')
    # 3. the deterministic chain on xrt's receiver samples (cast to
    #    float32 values), float32 against float64
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        SX_GOLDEN)
    check(os.path.isfile(path), f'{SX_GOLDEN} is not in the tree')
    ref = dict(np.load(path))
    out = {dt: bs.deterministic_chain(ref, dt, 'cuda', f32_samples=True)
           for dt in (torch.float32, torch.float64)}
    ovs = {nm: overlap(out[torch.float64][nm], out[torch.float32][nm])
           for nm in SX_FLOORS}
    print('phase 14 deterministic chain on the golden samples, float32 vs '
          'float64 overlaps: ' + ', '.join(
              f'{nm} {v:.6f} (>{SX_FLOORS[nm]})' for nm, v in ovs.items()),
          flush=True)
    for nm, v in ovs.items():
        check(v > SX_FLOORS[nm], f'deterministic chain {nm}: overlap {v}')
    J32 = out[torch.float32]['focus_J'].sum()
    J64 = out[torch.float64]['focus_J'].sum()
    print(f'phase 14 focal flux float32 {J32:.6e}, float64 {J64:.6e}, '
          f'golden {float(ref["flux_focus"]):.6e}', flush=True)
    check(np.isfinite(J32) and J32 > 0 and J64 > 0,
          'deterministic chain: focal flux not finite and positive')


def prep_bytes(mode, nd, ns):
    """Bytes the preparation kernel must move for one call: every input
    read once (six floats a destination, seventeen a source) and its
    outputs written once (D, the zero-padded source rows, the centre)."""
    from xrt_tpu_torch.ops import kirchhoff as tk
    if mode in tk._DD_VARIANTS:
        dkeys, skeys = tk._DD_DST_KEYS, tk._DD_SRC_KEYS
    else:
        dkeys, skeys = tk._RECENTRED_KEYS[tk._RECENTRED_VARIANTS[mode]]
    ns_pad = -(-ns // tk.KERNEL_SRC_CHUNK) * tk.KERNEL_SRC_CHUNK
    width = -(-len(skeys) // 4) * 4
    return 4 * (6 * nd + 17 * ns + len(dkeys) * nd + width * ns_pad +
                tk.PREP_CENTRE)


def profiled_kernels_us(fn, n):
    """{kernel name: device us a call} of *n* calls of *fn*, by
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = collections.Counter()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            out[e.key] += getattr(e, 'self_device_time_total',
                                  getattr(e, 'self_cuda_time_total', 0.0)) / n
    return out


def host_us(fn, n):
    """Wall us a call of *n* calls of *fn*, ending synchronised."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / n


def phase_prep_kernel(timing):
    """Phase 38 (after phase 14): the Kirchhoff stages' preparation kernel
    (csrc/kirchhoff_prep.cu) at the SoftiMAX chain's shapes: a 4e4 x 2e4
    tile pair of M1 -> M2 (recentred mono), a contact tile pair of
    M2 -> PG ('fast'), and the untiled 2e5 x 2e5 stage PG -> M3; and at
    the main path's two hops (phase 3).  Its device time (torch.profiler,
    both launches) against its bytes bound and the plain preparation's,
    the host's time a call both ways; its six recentring means against the
    float64 means (1.5 ulp), and its keys and the whole call's sums against
    the plain preparation's: the same bits (both sum the recentring means
    in double, in orders whose float results differ only at a tie)."""
    import numpy as np
    import torch
    from xrt_tpu_torch import waves as W
    from xrt_tpu_torch.ops import _cuda, kirchhoff as tk
    rc, inputs = timing['softimax_chain']
    for fn, regs, st, ld in ptxas_rows(_cuda.build_log('kirchhoff_prep')):
        print(f'phase 38 ptxas kirchhoff_prep {fn}: {regs} registers, spill '
              f'stores {st} B, loads {ld} B', flush=True)
    cases = []
    for name in ('m2', 'pg'):
        args = W.kirchhoff_kernel_args(inputs[name], rc.waves[name])
        seen = set()
        for ij, (pm, am), pair, _ in W.tile_pair_args(args,
                                                      rc.tilemaps[name]):
            if pm not in seen:
                seen.add(pm)
                cases.append((f'{name} tile {ij}', pm, am, pair))
    cases.append(('m3 stage', 'recentred', 'vpu',
                  W.kirchhoff_kernel_args(inputs['m3'], rc.waves['m3'])))
    for hop, stage in enumerate(timing['stages'], 1):
        cases.append((f'main hop {hop}', 'recentred', 'vpu',
                      W.kirchhoff_kernel_args(*stage)))
    rows = []
    for label, pm, am, pair in cases:
        mode = 'mono' if pm == 'recentred' else pm
        xd, yd, zd, xs, ys, zs, Es, Ep, k, n, nl, w = pair
        nd, ns = xd[0].shape[0], xs[0].shape[0]
        args_n = (xd, yd, zd, xs, ys, zs, Es, Ep, k,
                  tk._broadcast_n(n, ns, xs[0]), nl, w)
        check(tk._takes_prep_kernel(args_n),
              f'phase 38 {label}: the kernel does not take the call')
        flat = tk._flat_args(*args_n)

        def fused():
            return tk._prep_kernel(mode, flat)

        def plain():
            scheme, v, D, S, P = tk._kernel_inputs(*pair, mode)
            return scheme, v, D, tk.forward_sources(tk._pad_sources(S)), P
        kern = profiled_kernels_us(fused, 20)
        k_us = sum(kern.values())
        p_us = sum(profiled_kernels_us(plain, 3).values())
        kh_us, ph_us = host_us(fused, 50), host_us(plain, 5)
        got, ref = fused(), plain()
        same = [torch.equal(a, b) for a, b in zip(got[2:4], ref[2:4])]
        mean_ulps = 0.0
        if got[4] is not None:
            mine = got[4]._base[10:16].double().cpu().numpy()
            exact = np.array([float(t[0].double().mean())
                              for t in pair[:6]])
            mean_ulps = float(np.max(np.abs(mine - exact) / np.spacing(
                np.abs(exact).astype(np.float32))))
            same.append(torch.equal(got[4], ref[4]))
        kw = dict(phase_mode=pm, monochromatic=True, accumulate=am,
                  narrowband=False, check_envelope=False)
        grad_pair = (*pair[:-1], w.clone().requires_grad_(True))
        tk.LAUNCHES.clear()
        out = tk.kirchhoff_integral_kernel(*pair, **kw)
        launches = dict(tk.LAUNCHES)
        out_plain = [o.detach() for o in
                     tk.kirchhoff_integral_kernel(*grad_pair, **kw)]
        rel, _ = rel_err(out, out_plain)
        call_ms = statistics.median(cuda_ms(
            lambda: tk.kirchhoff_integral_kernel(*pair, **kw), 5)[0]
            for _ in range(3))
        plain_call_ms = statistics.median(cuda_ms(
            lambda: tk.kirchhoff_integral_kernel(*grad_pair, **kw), 2)[0]
            for _ in range(3))
        by = prep_bytes(mode, nd, ns)
        bytes_us = 1e6 * by / PEAK_BYTES
        print(f'phase 38 {label} ({mode}): {nd} x {ns}; preparation kernel '
              f'{k_us:.2f} us of device time a call ('
              f'{", ".join(f"{kk} {v:.2f}" for kk, v in kern.items())}), '
              f'bytes bound {bytes_us:.2f} us ({by / 1e6:.2f} MB, '
              f'{bytes_us / k_us:.1%}); plain preparation {p_us:.1f} us of '
              f'device time ({p_us / k_us:.0f}x); host a call {kh_us:.1f} / '
              f'{ph_us:.1f} us; means {mean_ulps:.2f} ulp from float64; '
              f'D, rows (P) equal to the plain ones: {same}; the '
              f'whole call {call_ms:.3f} ms, with the plain preparation '
              f'(weights requiring grad) {plain_call_ms:.3f} ms; sums against '
              f'the plain preparation\'s {rel:.2e}; launches {launches}',
              flush=True)
        fwd = 'kirchhoff_recentred' if pm == 'recentred' else \
            'kirchhoff_ddphase'
        check(launches == {f'prep:{mode}': 1, f'{fwd}:{mode}': 1},
              f'phase 38 {label}: launches {launches}')
        check(all(same) and rel == 0.0 and mean_ulps <= 1.5,
              f'phase 38 {label}: {same}, {rel}, {mean_ulps}')
        rows.append(dict(label=label, mode=mode, nd=nd, ns=ns,
                         kernel_us=k_us, bytes_us=bytes_us, plain_us=p_us,
                         host_us=kh_us, plain_host_us=ph_us,
                         call_ms=call_ms, plain_call_ms=plain_call_ms))
    timing['prep_kernel'] = rows


def prep_rows(timing):
    """Phase 38's kernel-line rows: the preparation kernel at each shape,
    with the launches of its mode on the main path's own counted runs
    (phase 3 for mono, phase 4's B2 run for 'fast' and 'exact')."""
    counted = dict(timing['b2_launches'], **{
        k: v for k, v in timing['main']['launches'].items()
        if k == 'prep:mono'})
    return [dict(name=f'kirchhoff_prep:{r["mode"]}:'
                      f'{"-".join(re.findall("[a-z0-9]+", r["label"]))}',
                 route='cuda', source=SOURCES['kirchhoff_prep'],
                 replaces=REPLACES['kirchhoff_prep'],
                 launches=int(counted.get(f'prep:{r["mode"]}', 0)),
                 ms=r['kernel_us'] * 1e-3, bound_ms=r['bytes_us'] * 1e-3,
                 bound_by='bytes', plain_ms=r['plain_us'] * 1e-3,
                 call_ms=r['call_ms'], plain_call_ms=r['plain_call_ms'],
                 library_ms=None, shape=f'{r["nd"]}x{r["ns"]}')
            for r in timing['prep_kernel']]


def sliced_adjoint_errors(scheme, v, D, S, P, G, got, Ns):
    """The adjoint kernels' result *got* at a main-path shape against the
    plain blocked backward on the slices it can do in seconds.  Returns
    the largest row error of the destination rows, of the source rows and
    of the scalars, and the largest absolute difference."""
    import torch
    from xrt_tpu_torch.ops import kirchhoff as tk
    d0, s0 = D.shape[1] - ADJ_DST_SLICE, Ns - ADJ_SRC_SLICE
    # the last destinations against all sources: their rows, and what they
    # alone give to every source row and to the scalars
    refD, refS_of_d, refP_of_d = tk.kirchhoff_bwd_blocked(
        scheme, v, D[:, d0:], S[:, :Ns], P, G[:, d0:])
    relD, ab = row_errors(got[0][:, d0:], refD)
    # the last sources against all destinations: their rows
    refS = tk.kirchhoff_bwd_blocked(scheme, v, D, S[:, s0:Ns], P, G)[1]
    relS, abS = row_errors(got[1][:, s0:Ns], refS)
    # the same shape once more, with zero cotangents but for the last
    # destinations: every source row and the scalars
    Gm = torch.zeros_like(G)
    Gm[:, d0:] = G[:, d0:]
    gm = launch_adjoint(scheme, v, D, S, P, Gm)
    check(not bool(gm[0][:, :d0].any()),
          'destinations with zero cotangents got non-zero rows')
    relSm, abSm = row_errors(gm[1][:, :Ns], refS_of_d)
    relP, abP = (0.0, 0.0) if refP_of_d is None else \
        row_errors(gm[2][:, None], refP_of_d[:, None])
    return relD, max(relS, relSm), relP, max(ab, abS, abSm, abP)


def adjoint_rows(timing):
    """The rows of the adjoint kernels at their paths' shapes."""
    import torch
    from xrt_tpu_torch import histogram as th, waves as W
    from xrt_tpu_torch.ops import kirchhoff as tk
    rows = []
    stages = timing['stages']
    specs = [('kirchhoff_recentred_bwd', 'mono', stages[0],
              timing['grad_launches']),
             ('kirchhoff_recentred_bwd', 'mono', stages[1],
              timing['grad_launches']),
             ('kirchhoff_ddphase_bwd', 'fast', stages[1],
              timing['b2_grad_launches']),
             ('kirchhoff_ddphase_bwd', 'exact', stages[1],
              timing['b2_grad_launches'])]
    for name, variant, stage, launches in specs:
        args = W.kirchhoff_kernel_args(*stage)
        scheme, v, D, S, P = tk._kernel_inputs(*args, variant)
        S = tk._pad_sources(S)
        Nd, Ns = D.shape[1], stage[0].x.shape[0]
        G = torch.randn((10, Nd), device='cuda',
                        generator=torch.Generator('cuda').manual_seed(9))
        got = launch_adjoint(scheme, v, D, S, P, G)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t).all()) for t in got
                  if t is not None),
              f'{name}:{variant} at {Nd} x {Ns}: non-finite cotangents')
        ms = statistics.median(cuda_ms(lambda: launch_adjoint(
            scheme, v, D, S, P, G))[0] for _ in range(3))
        # the second kernel's share: the partials of one pass summed
        parts = tk._adjoint_pass(scheme, v, D, S, P, G)
        red_ms = statistics.median(cuda_ms(lambda: tk._adjoint_reduce(
            scheme, v, parts[0], parts[1], D, S))[0] for _ in range(3))
        scratch = sum(t.numel() * t.element_size() for t in parts
                      if t is not None)
        del parts
        regs, spill = kernel_registers(scheme, v, adjoint=True)
        t0 = time.perf_counter()
        relD, relS, relP, ab = sliced_adjoint_errors(scheme, v, D, S, P, G,
                                                     got, Ns)
        t_ref = time.perf_counter() - t0
        key = f'{name}:{variant}'
        bms, by = bound_ms(key, Nd, Ns)
        # the plain version's time at this shape where the gradient main
        # path's reference step ran it, else at 8192 x 16384
        if variant == 'mono':
            plain_ms, plain_shape = timing['grad_plain_ms'][Nd], f'{Nd}x{Ns}'
        else:
            plain_ms, plain_shape = timing['adjoint_plain_ms'][variant], \
                '8192x16384'
        print(f'phase 5 {key}: {Nd} x {Ns} pairs, kernel {ms:.2f} ms (one '
              f'pass, the reduction of its partials {red_ms:.3f} ms of it), '
              f'bound {bms:.2f} ms ({by}), {bms / ms:.1%} of bound, '
              f'{Nd * Ns / (ms * 1e-3):.3e} pairs/s; scratch '
              f'{scratch / 2 ** 30:.3f} GiB; {regs} registers, {spill} B '
              f'spilled; against the plain '
              f'blocked backward on the last {ADJ_DST_SLICE} destinations '
              f'and the last {ADJ_SRC_SLICE} sources ({t_ref:.1f} s), max '
              f'row rel: dst keys {relD:.2e}, src keys {relS:.2e}, scalars '
              f'{relP:.2e} (limit {ADJ_LIMIT:.0e}); plain blocked backward '
              f'at {plain_shape} {plain_ms:.1f} ms', flush=True)
        check(max(relD, relS, relP) < ADJ_LIMIT,
              f'{key} at {Nd} x {Ns}: {relD:.3e} / {relS:.3e} / {relP:.3e}')
        rows.append(dict(name=f'{key}:{Nd}x{Ns}', route='cuda',
                         source=SOURCES[name], replaces=REPLACES[name],
                         launches=int(launches.get(key, 0)),
                         max_abs_err=ab, max_rel_err=max(relD, relS, relP),
                         err_shape=f'{Nd}x{Ns}, on slices', ms=ms,
                         reduce_ms=red_ms, scratch_bytes=scratch,
                         registers=regs, spill_bytes=spill,
                         plain_ms=plain_ms, plain_shape=plain_shape,
                         bound_ms=bms, bound_by=by, library_ms=None,
                         library=None, library_reason=NO_LIBRARY))
        check(rows[-1]['launches'] > 0, f'{key} was not launched on its '
              'path')

    # B4-bwd on the rays of a main-path pass: the gather of a (128, 128, k)
    # cotangent, k = 1 as in the trace gradient and k = 3 as through a
    # colour plot; the library call is the advanced-indexing gather
    tr = timing['trace']
    x, y, bins = tr['x'], tr['y'], 128
    fx, inx = th._bin_index(x, tr['xlim'], bins)
    fy, iny = th._bin_index(y, tr['ylim'], bins)
    flat = torch.where(inx & iny, fy * bins + fx,
                       torch.zeros_like(fx)).long()
    n = x.shape[0]
    for k in (1, 3):
        g = torch.rand((bins, bins, k), device='cuda',
                       generator=torch.Generator('cuda').manual_seed(3))
        args = (x, y, g, bins, bins, tr['xlim'], tr['ylim'])
        th.hist2d_bwd_kernel(*args)
        torch.cuda.synchronize()
        ms = statistics.median(cuda_ms(
            lambda: th.hist2d_bwd_kernel(*args), 5)[0] for _ in range(3))
        got = th.hist2d_bwd_kernel(*args)
        plain_ms, ref = cuda_ms(lambda: th.hist2d_bwd_plain(*args))
        key = f'hist2d_bwd:k{k}'
        check(torch.equal(got, ref), f'{key} at main-path shapes differs '
              'from indexing')
        g2 = g.reshape(-1, k)
        lib_ms = statistics.median(cuda_ms(lambda: g2[flat], 3)[0]
                                   for _ in range(3))
        bms = 1e3 * (4.0 * n * (2 + k) + 4.0 * bins * bins * k) / PEAK_BYTES
        print(f'phase 5 {key}: {n} rays from {bins} x {bins} x {k}, '
              f'kernel {ms:.3f} ms ({bms / ms:.1%} of bound), plain '
              f'{plain_ms:.2f} ms, indexing gather {lib_ms:.3f} ms '
              f'({bms / lib_ms:.1%}), bound {bms:.3f} ms (bytes); kernel / '
              f'indexing {ms / lib_ms:.3f}; {n / (ms * 1e-3):.3e} rays/s, '
              f'equal to indexing', flush=True)
        rows.append(dict(name=key, route='cuda', source=SOURCES['hist2d'],
                         replaces=REPLACES['hist2d'],
                         launches=int(timing['trace_grad_launches'].get(
                             key, 0)),
                         max_abs_err=float((got - ref).abs().max()),
                         max_rel_err=0.0, ms=ms, plain_ms=plain_ms,
                         bound_ms=bms, bound_by='bytes', library_ms=lib_ms))
        check(rows[-1]['launches'] > 0, f'{key} was not launched on its '
              'path')
    return rows


# ---------------------------------------------------------------------------
# the crystal slice: speed test 1, the DCM trace, BASELINE configuration 4
# ---------------------------------------------------------------------------

def step_split(fns):
    """Device ms of each of *fns* called in turn (CUDA events) and their
    results."""
    import torch
    ev = events(len(fns) + 1)
    outs = []
    ev[0].record()
    for i, fn in enumerate(fns):
        outs.append(fn(*outs[-1:]) if i else fn())
        ev[i + 1].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(len(fns))], outs


def search_alone(oe, beam):
    """Device ms of the bracket and the Illinois search of *oe* on *beam*
    (its frame as reflect takes it), and the number of Illinois
    iterations."""
    import torch
    from xrt_tpu_torch.oes import base as oebase
    from xrt_tpu_torch.transforms import global_to_virgin_local, rotate_beam
    pitch, roll, yaw = oe._placement()[0:3]
    lb = rotate_beam(global_to_virgin_local(beam, oe.center),
                     rotationSequence=oe.rotationSequence, pitch=-pitch,
                     roll=-roll, yaw=-yaw)
    rays = (lb.x, lb.y, lb.z, lb.a, lb.b, lb.c)
    evals = []      # both bracket ends, the iterations, two Newton steps

    def counted_z(xx, yy):
        evals.append(1)
        return oe.local_z(xx, yy)
    ev = events(2)
    torch.cuda.synchronize()
    ev[0].record()
    oebase.find_intersection(counted_z, *oe._bracket(*rays), *rays,
                             active=lb.state > 0)
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]), len(evals) - 4


def profiled_device_ms(fn):
    """The device time of the kernels *fn* launches, by torch.profiler (0
    when it sees none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            total += getattr(e, 'self_device_time_total',
                             getattr(e, 'self_cuda_time_total', 0.0))
    return total / 1e3


def phase_analyzer(timing):
    """Phase 15: xrt's speed test 1 (tools/torch_bench_analyzer.py) with
    nothing cut: 3 sources x 96 steps x 1e5 rays, float32."""
    import torch
    from xrt_tpu_torch import histogram as th
    tool = port_tool('torch_bench_analyzer')
    nrays, reps = AN_NRAYS, AN_REPEATS
    res = tool.run(nrays, reps, torch.float32, seed=15)
    launches = res['launches']
    print(f"phase 15 speed test 1: {res['rays']:.3g} rays (3 sources x "
          f"{reps} x {nrays}), {res['seconds']:.3f} s = "
          f"{res['rays_per_s']:.4e} rays/s; per source "
          f"{', '.join(f'{t:.3f} s' for t in res['per_source'])}; "
          f"accumulated flux {res['flux']:.6e}; histogram launches "
          f"{launches}; xrt on an i7-7700K (context only): "
          f"{tool.XRT_I7_1THREAD} s on 1 thread, {tool.XRT_I7_4PROC} s on "
          f"4 processes", flush=True)
    check(sum(launches.values()) == 3 * 3 * reps and all(
        k.startswith('hist2d:k1:') for k in launches),
        f'speed test 1: histogram launches {launches}')
    check(math.isfinite(res['flux']) and res['flux'] > 0,
          f"speed test 1: accumulated flux {res['flux']}")
    # one step of each source split by CUDA events; the search alone
    sources, analyzer, detector, _ = tool.build(nrays, torch.float32,
                                                'cuda')
    gen = torch.Generator('cuda').manual_seed(16)
    splits = []
    for src in sources:
        ms, (beam, (loc, det), hs) = step_split([
            lambda: src.shine(gen),
            lambda b: tool.trace(analyzer, detector, b, gen),
            lambda ld: tool.histograms(*ld)])
        ms_r, _ = step_split([lambda: analyzer.reflect(beam, gen),
                              lambda g: detector.expose(g[0])])
        s_ms, iters = search_alone(analyzer, beam)
        splits.append((ms[0], ms_r[0], ms_r[1], ms[2], s_ms, iters))
    for i, (src_ms, refl, expo, hist, s_ms, it) in enumerate(splits):
        step = src_ms + refl + expo + hist
        print(f'phase 15 source {i} one step (CUDA events): source '
              f'{src_ms:.2f} ms, reflect {refl:.2f} ms (the generic '
              f'bracket + search alone {s_ms:.2f} ms in {it} Illinois '
              f'iterations; the reflect takes the kernel), expose '
              f'{expo:.2f} ms, three histograms {hist:.3f} ms '
              f'({100 * hist / step:.2f}% of the step)', flush=True)
    # the device's busy share of a step: the kernel time torch.profiler
    # sees over one more step of source 0, against that step's wall time
    # without the profiler
    src = sources[0]

    def one_step():
        tool.histograms(*tool.trace(analyzer, detector, src.shine(gen),
                                    gen))
    busy = profiled_device_ms(one_step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_step()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    print(f'phase 15 one step of source 0: wall {wall:.2f} ms, device busy '
          + (f'{busy:.2f} ms by torch.profiler ({100 * busy / wall:.1f}%; '
             f'idle {100 * (1 - busy / wall):.1f}%)' if busy else
             'not measured (the profiler saw no device time)'), flush=True)
    # the histogram kernel against its plain version on one step's rays
    kargs = []
    for (name, xf, yf, bins, xl, yl), b in zip(tool.HISTS,
                                                (loc, loc, det)):
        w = torch.where(b.state == 1, b.Jss + b.Jpp,
                        torch.zeros_like(b.Jss))[:, None].contiguous()
        args = (getattr(b, xf).contiguous(), getattr(b, yf).contiguous(),
                w, bins, bins, xl, yl)
        got = th.hist2d_kernel(*args)
        ref = th.hist2d_plain(*args, sum_dtype=torch.float64)
        rel, ab, same = hist_errors(got, ref)
        print(f'phase 15 hist2d_kernel {bins} x {bins} ({name}): {nrays} '
              f'rays, kernel vs plain float64 sums max rel {rel:.2e}, '
              f'non-empty bins identical {same}', flush=True)
        check(same and rel < 1e-5,
              f'speed test 1 histogram {bins}: {rel:.3e}, bins {same}')
        kargs.append(args)
    timing['analyzer'] = dict(launches=launches, args=kargs,
                              step_ms=[sum(s[:4]) for s in splits],
                              hist_ms=[s[3] for s in splits])


def search_inputs(oe, beam):
    """The local rays, bracket and active mask of *oe*'s search on
    *beam*, as OE._reflect_local forms them, and its search function."""
    import torch
    from xrt_tpu_torch.transforms import global_to_virgin_local, rotate_beam
    pitch, roll, yaw = oe._placement()[0:3]
    lb = rotate_beam(global_to_virgin_local(beam, oe.center),
                     rotationSequence=oe.rotationSequence, pitch=-pitch,
                     roll=-roll, yaw=-yaw)
    rays = (lb.x, lb.y, lb.z, lb.a, lb.b, lb.c)

    def dz_fn(xx, yy, zz):
        surf = oe.local_z(xx, yy)
        return zz - torch.where(torch.isnan(surf), torch.zeros_like(surf),
                                surf)
    return rays, oe._bracket(*rays), lb.state > 0, dz_fn


def generic_copy(oe):
    """*oe* with its own surface as a plain function: the dispatch keeps
    it on the generic search."""
    own = oe.local_z
    return oe.replace(local_z=lambda x, y: own(x, y))


def search_differences(got, ref, tol_ulp=None, tol_mm=None):
    """(share of rays whose t differs by more than the tolerance, lost
    masks equal, largest difference in mm)."""
    import torch
    tg, tr = got[0].double(), ref[0].double()
    d = (tg - tr).abs()
    same_nan = torch.isnan(tg) == torch.isnan(tr)
    d = torch.where(torch.isnan(d), torch.zeros_like(d), d)
    if tol_ulp is not None:
        tr32 = ref[0].float()
        ulp = (torch.nextafter(tr32.abs(), torch.full_like(tr32, math.inf))
               - tr32.abs()).double()
        off = (d > tol_ulp * ulp) | ~same_nan
    else:
        off = (d > tol_mm) | ~same_nan
    return (float(off.double().mean()), bool(torch.equal(got[4], ref[4])),
            float(d.max()))


def phase_toroid_search(timing):
    """Phase 37 (run after phase 15): the toroid crystals' search kernel
    (csrc/toroid_search.cu, oes/toroid_search.py) against the generic
    search on the analyzer of speed test 1: 1e7 float32 rays (t, lost, the
    reflected beams' s and p flux, the kernel's time against its bounds),
    1e6 float64 rays, and the gradient case (t0 from the kernel, the
    Newton steps on the tape)."""
    import torch
    from xrt_tpu_torch.oes import base as oebase
    from xrt_tpu_torch.oes import toroid_search as ts
    from xrt_tpu_torch.ops import _cuda
    tool = port_tool('torch_bench_analyzer')
    for fn, regs, st, ld in ptxas_rows(_cuda.build_log('toroid_search')):
        print(f'phase 37 ptxas toroid_search {fn}: {regs} registers, '
              f'spill stores {st} B, loads {ld} B', flush=True)
    for dtype, nrays in ((torch.float32, TS_NRAYS),
                         (torch.float64, TS_NRAYS_F64)):
        sources, analyzer, _, _ = tool.build(nrays, dtype, 'cuda')
        gen = torch.Generator('cuda').manual_seed(37)
        beam = sources[0].shine(gen)
        rays, (tMin, tMax), active, dz_fn = search_inputs(analyzer, beam)
        check(ts.engages(analyzer, beam.x.device, dtype),
              'phase 37: the analyzer does not engage the kernel')
        ts.LAUNCHES.clear()

        def fused():
            return ts.search(analyzer, tMin, tMax, *rays, active, 1, dz_fn)

        def generic():
            return oebase.find_intersection_dz(dz_fn, tMin, tMax, *rays,
                                               active=active)
        fused()
        generic()      # the allocator's first growth out of the timing
        k_ms, got = cuda_ms(fused, 20)
        g_ms, ref = cuda_ms(generic, 2)
        f32 = dtype == torch.float32
        share, lost_eq, dmax = search_differences(
            got, ref, tol_ulp=4 if f32 else None,
            tol_mm=None if f32 else 1e-9)
        hit = int((active & ~ref[4] & (ref[0] < tMax)).sum())
        print(f'phase 37 {dtype} {nrays} analyzer rays ({hit} hit): kernel '
              f'{k_ms:.3f} ms, generic search {g_ms:.2f} ms '
              f'({g_ms / k_ms:.1f}x); t off by more than '
              f'{"4 ulp" if f32 else "1e-9 mm"} on {share:.3e} of the rays '
              f'(largest {dmax:.3e} mm), lost identical {lost_eq}; '
              f'launches {dict(ts.LAUNCHES)}', flush=True)
        check(lost_eq, f'phase 37 {dtype}: lost masks differ')
        check(share <= TS_T_SHARE, f'phase 37 {dtype}: t differs on '
              f'{share:.3e} of the rays')
        check(ts.LAUNCHES[f'toroid_search:{dtype}'] == 21,
              f'phase 37: launches {dict(ts.LAUNCHES)}')
        if f32:
            bytes_ms = 1e3 * 50 * nrays / PEAK_BYTES
            print(f'phase 37 kernel against its bounds: {k_ms:.3f} ms; '
                  f'bytes {bytes_ms:.3f} ms ({100 * bytes_ms / k_ms:.1f}%), '
                  f'instructions ~2 ms (~17 evaluations of ~400 '
                  f'instructions a ray)', flush=True)
            timing['toroid_search'] = dict(kernel_ms=k_ms, generic_ms=g_ms,
                                           bytes_ms=bytes_ms)
        # the reflected beams through the kernel and through the generic
        # search: the same rays, the same s and p flux
        outs = []
        for oe in (analyzer, generic_copy(analyzer)):
            ts.LAUNCHES.clear()
            glo, loc = oe.reflect(beam, torch.Generator('cuda').manual_seed(
                38))
            good = loc.state == 1
            outs.append((good, float(loc.Jss[good].double().sum()),
                         float(loc.Jpp[good].double().sum()),
                         sum(ts.LAUNCHES.values())))
        (gk, sk, pk, nk), (gg, sg, pg, ng) = outs
        ds, dp = abs(sk - sg) / abs(sg), abs(pk - pg) / abs(pg)
        same = float((gk != gg).double().mean())
        print(f'phase 37 {dtype} reflect: kernel launches {nk} / {ng}; good '
              f'rays {int(gk.sum())} / {int(gg.sum())} (differ on '
              f'{same:.2e}); s flux {sk:.9e} / {sg:.9e} ({ds:.2e}), p flux '
              f'{pk:.9e} / {pg:.9e} ({dp:.2e})', flush=True)
        check(nk == 1 and ng == 0, f'phase 37: reflect launches {nk}, {ng}')
        check(ds <= TS_FLUX_LIMIT and dp <= TS_FLUX_LIMIT,
              f'phase 37 {dtype}: flux {ds:.3e}, {dp:.3e}')
        del got, ref, beam, rays, tMin, tMax, active, outs, glo, loc
        torch.cuda.empty_cache()
    # the gradient case: t and dt/dh (h a height offset of the rays)
    sources, analyzer, _, _ = tool.build(100_000, torch.float64, 'cuda')
    beam = sources[0].shine(torch.Generator('cuda').manual_seed(39))
    rays, _, active, dz_fn = search_inputs(analyzer, beam)
    res = []
    for fn in ('fused', 'generic'):
        h = torch.zeros((), dtype=torch.float64, device='cuda',
                        requires_grad=True)
        r = (*rays[:2], rays[2] + h, *rays[3:])
        tMin, tMax = analyzer._bracket(*r)
        ts.LAUNCHES.clear()
        out = ts.search(analyzer, tMin, tMax, *r, active, 1, dz_fn) \
            if fn == 'fused' else oebase.find_intersection_dz(
                dz_fn, tMin, tMax, *r, active=active)
        hit = active & ~out[4] & (out[0] < tMax)
        g, = torch.autograd.grad(out[0][hit].sum(), h)
        res.append((out[0].detach(), float(g), sum(ts.LAUNCHES.values())))
    (tk, gk, nk), (tg, gg, _) = res
    dt = float((tk - tg).abs().nan_to_num(0).max())
    print(f'phase 37 gradient case (float64, 1e5 rays): kernel launches '
          f'{nk}, t within {dt:.2e} mm, dt/dh {gk:.12e} / {gg:.12e}',
          flush=True)
    check(nk == 1 and dt <= 1e-9 and abs(gk - gg) <= 1e-9 * abs(gg),
          f'phase 37 gradient case: {nk}, {dt:.3e}, {gk}, {gg}')


def dcm_trace_line(nrays, dtype):
    """GeometricSource -> Si(111) DCM -> screen at the geometry of
    tests/golden/ref_trace_dcm.npz: 30 m, fixed exit 20 mm, +-8 eV."""
    import numpy as np
    import os
    from xrt_tpu_torch.materials import CrystalSi
    from xrt_tpu_torch.oes import DCM
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import GeometricSource
    gold = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                DCM_GOLDEN))
    src = GeometricSource.create(
        nrays=nrays, dx=0.1, dz=0.05, dxprime=1e-5, dzprime=1e-5,
        distE='flat', energies=(DCM_E0 - 8, DCM_E0 + 8),
        polarization='horizontal', dtype=dtype, device='cuda')
    dcm = DCM.create(center=(0, DCM_P, 0),
                     material=CrystalSi.create(hkl=(1, 1, 1), dtype=dtype,
                                               device='cuda'),
                     bragg=float(gold['thetaB']), fixedOffset=20.0,
                     limPhysX=(-50, 50), limPhysY=(-500, 500))
    scr = Screen.create(center=(0, DCM_P + 1000.0, 20.0))
    return src, dcm, scr, gold


def dcm_sums(g):
    """(rays, sum I, sum I E, sum I E^2) of the transmitted rays of a DCM's
    exit beam, float64 sums on the device (no host read)."""
    import torch
    I = torch.where(g.state == 1, g.Jss + g.Jpp,
                    torch.zeros_like(g.Jss)).double()
    E = g.E.double()
    return torch.stack([torch.full_like(I[0], g.E.shape[0]), I.sum(),
                        (I * E).sum(), (I * E * E).sum()])


def dcm_moments(sums):
    """(flux per ray, weighted E mean, E spread) from ``dcm_sums`` of one
    or more passes."""
    import torch
    n, flux, sE, sE2 = torch.stack(list(sums)).sum(0).tolist()
    Em = sE / flux
    return flux / n, Em, math.sqrt(max(sE2 / flux - Em * Em, 0.0))


def dcm_plot(bins=128):
    from xrt_tpu_torch.plotspec import XYCAxis, XYCPlot
    return XYCPlot(beam='screen', xaxis=XYCAxis('x', 'mm', bins=bins),
                   yaxis=XYCAxis('z', 'mm', bins=bins),
                   caxis=XYCAxis('energy', 'eV', bins=bins,
                                 limits=(DCM_E0 - 10, DCM_E0 + 10)))


def phase_dcm(timing):
    """Phase 16: the DCM trace at 1e7 rays a pass through
    run_ray_tracing, against the golden."""
    import torch
    from xrt_tpu_torch import histogram as th, runner
    n, reps = TRACE_NRAYS, TRACE_REPEATS
    src, dcm, scr, gold = dcm_trace_line(n, torch.float32)
    entries, sums = [], []

    def run_process(beamLine, rng):
        torch.cuda.synchronize()
        entries.append(time.perf_counter())
        glo = dcm.double_reflect(src.shine(rng), rng)[0]
        sums.append(dcm_sums(glo))
        return {'screen': scr.expose(glo)}

    torch.cuda.reset_peak_memory_stats()
    rng = torch.Generator('cuda').manual_seed(21)
    th.LAUNCHES.clear()
    pass_ms, cal_ms = [], []
    for rep in range(4):        # a warm-up and 3 timed runs
        plot = dcm_plot()
        entries.clear()
        sums.clear()
        runner.run_ray_tracing(plot, repeats=reps, run_process=run_process,
                               rng=rng)
        torch.cuda.synchronize()
        t = entries + [time.perf_counter()]
        if rep:
            cal_ms.append(1e3 * (t[1] - t[0]))
            pass_ms.append(statistics.median(
                1e3 * (b - a) for a, b in zip(t[1:-1], t[2:])))
    launches = dict(th.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(pass_ms)
    flux, Em, Es = dcm_moments(sums[1:])    # the passes of the last run
    gf, gE, gs = (float(gold[k]) for k in ('flux_per_ray', 'E_mean',
                                           'E_std'))
    print(f'phase 16 DCM trace: {n} rays/pass, float32, {reps} repeats + '
          f'calibration; calibration pass {statistics.median(cal_ms):.1f} '
          f'ms; pass median of 3 runs {med:.1f} ms '
          f'({", ".join(f"{v:.1f}" for v in pass_ms)}); '
          f'{n / (med * 1e-3):.3e} rays/s; peak device memory '
          f'{peak / 2 ** 30:.2f} GiB; launches of the 4 runs {launches}',
          flush=True)
    print(f'phase 16 DCM against ref_trace_dcm.npz ({reps} x {n} rays): '
          f'flux per ray {flux:.6f} (golden {gf:.6f}, '
          f'{abs(flux / gf - 1):.2e}; limit 2e-2), E mean {Em:.4f} eV '
          f'({gE:.4f}, {abs(Em - gE):.4f}; limit 0.05), E std {Es:.4f} '
          f'eV ({gs:.4f}, {abs(Es / gs - 1):.2e}; limit 3e-2); plot '
          f'intensity {plot.intensity:.6e}, nRaysGood {plot.nRaysGood}',
          flush=True)
    check(abs(flux / gf - 1) < 0.02, f'DCM flux per ray {flux} vs {gf}')
    check(abs(Em - gE) < 0.05, f'DCM E mean {Em} vs {gE}')
    check(abs(Es / gs - 1) < 0.03, f'DCM E std {Es} vs {gs}')
    check(launches == {f'hist_plot:{th.plot_route((128,) * 3)}': 4 * reps},
          f'DCM trace: not one hist_plot launch per pass: {launches}')
    # one pass split by CUDA events
    ms, (beam, glo, img, hists) = step_split([
        lambda: src.shine(rng), lambda b: dcm.double_reflect(b, rng)[0],
        lambda g: scr.expose(g),
        lambda i: runner.histogram_plot(plot, {'screen': i})])
    s_ms, iters = search_alone(dcm.replace(pitch=dcm.pitch + dcm.braggAngle),
                               beam)
    print(f'phase 16 split of one pass (CUDA events): source {ms[0]:.1f} ms, '
          f'double_reflect {ms[1]:.1f} ms (the first crystal\'s bracket + '
          f'search alone {s_ms:.1f} ms in {iters} Illinois iterations), '
          f'expose {ms[2]:.1f} ms, histograms {ms[3]:.2f} ms', flush=True)
    # hist_plot against its plain version on this pass
    x, y, cData, inten, fl, mask, _ = runner._plot_arrays(
        plot, {'screen': img})
    args = (x, y, cData, fl, inten, mask, (128, 128, 128),
            tuple(tuple(a.limits) for a in (plot.xaxis, plot.yaxis,
                                             plot.caxis)),
            plot.colorFactor, plot.colorSaturation)
    rel, same = plot_errors(th.hist_plot_kernel(*args),
                            th.hist_plot_plain(*args,
                                               sum_dtype=torch.float64))
    print(f'phase 16 hist_plot on a DCM pass: eight histograms vs plain '
          f'float64 sums max rel {rel:.2e}, bins identical {same}',
          flush=True)
    check(same and rel < 1e-5, f'DCM hist_plot: {rel:.3e}, bins {same}')
    timing['dcm'] = dict(launches=launches, plot_args=args)

    # float32 against float64 on the same 2e5 rays (float64 draws)
    res = {}
    for dt in (torch.float32, torch.float64):
        s_, d_, _, _ = dcm_trace_line(DCM_CROSS_NRAYS, dt)
        g = d_.double_reflect(s_.shine(torch.Generator().manual_seed(5)))[0]
        res[dt] = dcm_moments([dcm_sums(g)])
    (f32, E32, s32), (f64, E64, s64) = res[torch.float32], \
        res[torch.float64]
    print(f'phase 16 DCM float32 vs float64, {DCM_CROSS_NRAYS} rays: flux '
          f'per ray {f32:.6f} / {f64:.6f} ({abs(f32 / f64 - 1):.2e}), E '
          f'mean {E32:.4f} / {E64:.4f} eV ({abs(E32 - E64):.2e}), E std '
          f'{s32:.4f} / {s64:.4f} ({abs(s32 / s64 - 1):.2e})', flush=True)
    check(abs(f32 / f64 - 1) < 2e-3 and abs(E32 - E64) < 0.01 and
          abs(s32 / s64 - 1) < 2e-3, 'DCM float32 vs float64')


def config4_line(nrays, dtype, gNodes=64):
    """BASELINE configuration 4 as examples/02_undulator_dcm_kb.py builds
    it with BeamLine.place (the undulator at *gNodes*; None: the
    quadrature search)."""
    from xrt_tpu_torch.beamline import BeamLine
    from xrt_tpu_torch.materials import CrystalSi, Material
    from xrt_tpu_torch.oes import DCM, EllipticalMirrorParam
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import Undulator
    dk = dict(dtype=dtype, device='cuda')
    E0, pitch = DCM_E0, 3.5e-3
    bl = BeamLine(alignE=E0)
    bl.add('source', Undulator.create(
        nrays=nrays, eE=3.0, eI=0.5, period=18.0, n=111, targetE=(E0, 7),
        eEpsilonX=0.263, eEpsilonZ=0.008, betaX=9.0, betaZ=2.0,
        eMin=E0 - 40, eMax=E0 + 40, xPrimeMax=0.02, zPrimeMax=0.02,
        gNodes=gNodes, **dk))
    bl.place('dcm', DCM, distance=30000.0,
             material=CrystalSi.create(hkl=(1, 1, 1), **dk), alignE=E0,
             fixedOffset=20.0, limPhysX=(-50, 50), limPhysY=(-500, 500))
    rh = Material.create('Rh', rho=12.41, **dk)
    bl.place('vfm', EllipticalMirrorParam, distance=3000.0, pitch=pitch,
             p=33000.0, q=1400.0, isCylindrical=True, material=rh,
             limPhysX=(-10, 10), limPhysY=(-150, 150), deflection='up')
    bl.place('hfm', EllipticalMirrorParam, distance=400.0, pitch=pitch,
             p=33400.0, q=1000.0, positionRoll=-math.pi / 2,
             isCylindrical=True, material=rh, limPhysX=(-10, 10),
             limPhysY=(-150, 150), deflection='left')
    bl.add('focus', Screen.create(center=tuple(bl.axis_point +
                                              bl.axis_dir * 1000.0)))
    return bl


def phase_config4(timing):
    """Phase 17: BASELINE configuration 4 (undulator -> DCM -> KB ->
    focus) at 1e6 rays a pass through run_ray_tracing."""
    import torch
    from xrt_tpu_torch import histogram as th, runner
    from xrt_tpu_torch.plotspec import XYCAxis, XYCPlot
    n, reps = C4_NRAYS, C4_REPEATS
    bl = config4_line(n, torch.float32)
    und = bl['source']
    entries, shine_ev, sizes = [], [], []

    def masked_std(v, m):
        v, m = v.double(), m.double()
        cnt = m.sum()
        mean = (v * m).sum() / cnt
        return torch.sqrt(((v - mean) ** 2 * m).sum() / (cnt - 1))

    def run_process(beamLine, rng):
        torch.cuda.synchronize()
        entries.append(time.perf_counter())
        ev = events(2)
        ev[0].record()
        beam = und.shine(rng)
        ev[1].record()
        shine_ev.append(ev)
        mono = bl['dcm'].double_reflect(beam, rng)[0]
        b2 = bl['hfm'].reflect(bl['vfm'].reflect(mono, rng)[0], rng)[0]
        img = bl['focus'].expose(b2)
        I = torch.where(img.state == 1, img.Jss + img.Jpp,
                        torch.zeros_like(img.Jss))
        good = I > 1e-3 * I.max()
        sizes.append(torch.stack([good.sum().double(),
                                  masked_std(img.x, good),
                                  masked_std(img.z, good)]))
        return {'focus': img}

    def plot():
        return XYCPlot(beam='focus',
                       xaxis=XYCAxis('x', 'um', limits=(-20, 20),
                                     factor=1e3),
                       yaxis=XYCAxis('z', 'um', limits=(-20, 20),
                                     factor=1e3),
                       caxis=XYCAxis('energy', 'eV',
                                     limits=(DCM_E0 - 3, DCM_E0 + 3)))
    rng = torch.Generator('cuda').manual_seed(17)
    runner.run_ray_tracing(plot(), repeats=1, run_process=run_process,
                           rng=rng)         # warm-up
    torch.cuda.synchronize()
    entries.clear()
    shine_ev.clear()
    sizes.clear()
    torch.cuda.reset_peak_memory_stats()
    th.LAUNCHES.clear()
    p = plot()
    runner.run_ray_tracing(p, repeats=reps, run_process=run_process,
                           rng=rng)
    torch.cuda.synchronize()
    t = entries + [time.perf_counter()]
    pass_ms = [1e3 * (b - a) for a, b in zip(t[:-1], t[1:])]
    shine_ms = [e[0].elapsed_time(e[1]) for e in shine_ev]
    launches = dict(th.LAUNCHES)
    sz = torch.stack(sizes).tolist()
    print(f'phase 17 configuration 4: {n} rays/pass ({n * und.oversample} '
          f'undulator candidates, gNodes 64), float32, {reps} passes; '
          f'pass {", ".join(f"{v:.1f}" for v in pass_ms)} ms, of which the '
          f'undulator shine {", ".join(f"{v:.1f}" for v in shine_ms)} ms; '
          f'{n / (statistics.median(pass_ms) * 1e-3):.3e} rays/s; peak '
          f'device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}'
          f' GiB; launches {launches}', flush=True)
    for i, (ng, sx, sz_) in enumerate(sz):
        print(f'phase 17 pass {i} focus: {int(ng)} rays above 1e-3 of the '
              f'peak, size (std) x {1e3 * sx:.3f} um, z {1e3 * sz_:.3f} um '
              f'(limit 20 um)', flush=True)
        check(ng > 100 and sx < 0.02 and sz_ < 0.02,
              f'configuration 4 focus: {ng} rays, {sx} x {sz_} mm')
    print(f'phase 17 plot: intensity {p.intensity:.6e}, flux {p.flux:.6e} '
          f'ph/s, FWHM x {p.dx:.3f} um, z {p.dy:.3f} um, nRaysGood '
          f'{p.nRaysGood}', flush=True)
    check(math.isfinite(p.intensity) and p.intensity > 0,
          'configuration 4: no intensity')
    check(launches == {f'hist_plot:{th.plot_route((p.xaxis.bins,) * 3)}':
                       reps}, f'configuration 4 launches {launches}')
    # the resampling's cumulative sum over the candidates, float32
    g = torch.Generator('cuda').manual_seed(18)
    M = n * und.oversample
    u = [torch.rand(M, generator=g, device='cuda') for _ in range(3)]
    rE = u[0] * (und.eMax - und.eMin) + und.eMin
    rT = u[1] * (und.Theta_max - und.Theta_min) + und.Theta_min
    rP = u[2] * (und.Psi_max - und.Psi_min) + und.Psi_min
    I = und._I_map_blocks(g, rE, rT, rP)[0]
    pc = torch.cumsum(I / I.sum(), dim=0)
    pc64 = torch.cumsum((I / I.sum()).double(), dim=0)
    print(f'phase 17 resampling: cumulative sum over {M} candidates in '
          f'float32 ends at 1 {float(pc[-1]) - 1:+.3e} (float64 sum of the '
          f'same terms {float(pc64[-1]) - 1:+.3e}); largest gap to the '
          f'float64 sum {float((pc.double() - pc64).abs().max()):.3e}',
          flush=True)
    timing['config4'] = dict(pass_ms=pass_ms, shine_ms=shine_ms)


def crystal_hist_rows(timing):
    """The histogram kernel's rows on the crystal slice's paths:
    ``hist2d_kernel`` at speed test 1's shapes (phase 15's launches) and
    ``hist_plot`` on a DCM pass (phase 16's launches)."""
    import torch
    from xrt_tpu_torch import histogram as th
    an = timing['analyzer']
    rows = []
    for name, idx in (('hist2d:speedtest:400', 0),
                      ('hist2d:speedtest:128', 1)):
        args = an['args'][idx]
        bins = args[3]
        route = th.hist_route(bins, bins, 1)
        kernel = lambda: th.hist2d_kernel(*args)
        kernel()
        torch.cuda.synchronize()
        ms = statistics.median(cuda_ms(kernel, 20)[0] for _ in range(3))
        got = kernel()
        plain_ms, _ = cuda_ms(lambda: th.hist2d_plain(*args))
        ref = th.hist2d_plain(*args, sum_dtype=torch.float64)
        rel, ab, _ = hist_errors(got, ref)
        fx, inx = th._bin_index(args[0], args[5], bins)
        fy, iny = th._bin_index(args[1], args[6], bins)
        inside = inx & iny
        flat = torch.where(inside, fy * bins + fx,
                           torch.zeros_like(fx)).long()
        w = torch.where(inside[:, None], args[2], torch.zeros_like(args[2]))
        library = lambda: torch.zeros((bins * bins, 1), device='cuda'
                                      ).index_add_(0, flat, w)
        library()
        lib_ms = statistics.median(cuda_ms(library, 20)[0] for _ in range(3))
        n = args[0].shape[0]
        bms = 1e3 * (4.0 * n * 3 + 4.0 * bins * bins) / PEAK_BYTES
        launches = int(an['launches'].get(f'hist2d:k1:{route}', 0))
        share = 100 * statistics.mean(h / s for h, s in zip(
            an['hist_ms'], an['step_ms']))
        print(f'phase 5 {name}: {n} rays into {bins} x {bins} ({route}), '
              f'kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, index_add_ '
              f'{lib_ms:.4f} ms, bound {bms:.4f} ms (bytes), launches '
              f'{launches}; the three histograms are {share:.2f}% of a '
              f'speed-test step', flush=True)
        rows.append(dict(name=name, route='cuda', source=SOURCES['hist2d'],
                         replaces=REPLACES['hist2d'], launches=launches,
                         max_abs_err=ab, max_rel_err=rel, ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, bound_by='bytes',
                         library_ms=lib_ms))
        check(launches > 0, f'{name} was not launched on its path')
    args = timing['dcm']['plot_args']
    route = th.plot_route((128,) * 3)
    kernel = lambda: th.hist_plot_kernel(*args)
    kernel()
    torch.cuda.synchronize()
    ms = statistics.median(cuda_ms(kernel, 5)[0] for _ in range(3))
    got = kernel()
    plain_ms, _ = cuda_ms(lambda: th.hist_plot_plain(*args))
    ref = th.hist_plot_plain(*args, sum_dtype=torch.float64)
    rel, _ = plot_errors(got, ref)
    ab = max(float((got[k].double() - ref[k]).abs().max())
             for k in th.PLOT_HISTS)
    n = args[0].shape[0]
    bms = 1e3 * (21.0 * n + 4.0 * (4 * (3 * 128 + 128 * 128) + 1)) / \
        PEAK_BYTES
    launches = int(timing['dcm']['launches'].get(f'hist_plot:{route}', 0))
    print(f'phase 5 hist_plot:dcm: {n} rays of a DCM pass into eight '
          f'histograms ({route}), kernel {ms:.4f} ms, plain {plain_ms:.2f} '
          f'ms, bound {bms:.4f} ms (bytes), launches {launches}',
          flush=True)
    rows.append(dict(name='hist_plot:dcm', route='cuda',
                     source=SOURCES['hist_plot'],
                     replaces=REPLACES['hist_plot'], launches=launches,
                     max_abs_err=ab, max_rel_err=rel, ms=ms,
                     plain_ms=plain_ms, bound_ms=bms, bound_by='bytes',
                     library_ms=None))
    check(launches > 0, 'hist_plot:dcm was not launched on its path')
    return rows


# ---------------------------------------------------------------------------
# the coherence slice: BASELINE configurations 5 and 2, the field maps
# ---------------------------------------------------------------------------

def config5_line(dtype):
    """BASELINE configuration 5 (tests/test_baseline_configs.py:156-198):
    the undulator (gNodes 64), the 80 um slit at 25 m, the Au zone plate
    (f = 2 m at 9 keV, 60 zones) at 27 m and the focal screen."""
    from xrt_tpu_torch.apertures import RectangularAperture
    from xrt_tpu_torch.materials import Material
    from xrt_tpu_torch.oes import NormalFZP
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import Undulator
    dk = dict(dtype=dtype, device='cuda')
    E0 = C5_E0
    und = Undulator.create(
        nrays=100, eE=3.0, eI=0.5, period=18.0, n=111, targetE=(E0, 7),
        eEpsilonX=0.263, eEpsilonZ=0.008, betaX=9.0, betaZ=2.0,
        xPrimeMax=0.02, zPrimeMax=0.02, gNodes=64, eMin=E0 - 1,
        eMax=E0 + 1, **dk)
    slit = RectangularAperture.create(center=(0, 25000.0, 0),
                                      opening=(-0.04, 0.04, -0.04, 0.04))
    fzp = NormalFZP.create(
        f=C5_F, E=E0, N=C5_N, center=(0, 27000.0, 0), pitch=math.pi / 2,
        material=Material.create('Au', rho=19.3, kind='FZP', **dk),
        order=1)
    scr = Screen.create(center=(0, 27000.0 + C5_F, 0))
    return und, slit, fzp, scr


def c5_run(dtype, electrons, nslit, nfzp, nfocus):
    """Configuration 5's coherent modes through the user's entry points:
    the filaments (the first through ``slit.propagate_wave`` from the
    undulator, which samples the slit; the others ``shine_wave`` on those
    samples), ``solve_modes``, and each mode slit -> zone plate
    (``prepare_wave_on_oe``, ``diffract``, the zone mask) -> focal grid
    (``Screen.expose_wave``).  Returns a dict of the results and the
    times (host clock around synchronized work; per hop CUDA events)."""
    import numpy as np
    import torch
    from xrt_tpu_torch import coherence as tc, modes as tmodes, waves as W
    sync = torch.cuda.synchronize
    und, slit, fzp, scr = config5_line(dtype)
    E0 = C5_E0
    g = torch.Generator().manual_seed(50)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w0 = slit.propagate_wave(None, nrays=nslit, prevOE=und, fixedEnergy=E0,
                             generator=g, dtype=dtype, device='cuda')
    sq = torch.sqrt(w0.area / nslit)
    norm = electrons ** 0.5
    fields = [(w0.Es * sq / norm, w0.Ep * sq / norm)]
    for _ in range(electrons - 1):
        w = und.shine_wave(g, w0, E0)
        fields.append((w.Es * sq / norm, w.Ep * sq / norm))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    modes, wAll, flux = tmodes.solve_modes(fields, C5_MODES)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    # the stack solve_modes decomposes (phaseEsEp = 0): its DoTC is the sum
    # of the squared weights
    dotc_slit = float(tc.calc_degree_of_transverse_coherence_PCA(
        torch.stack([f[0] + f[1] for f in fields])))
    del fields
    wave_fzp = W.prepare_wave_on_oe(fzp, slit, nfzp,
                                    generator=torch.Generator().manual_seed(
                                        51), dtype=dtype, device='cuda')
    zmask = fzp.rays_good(wave_fzp.x, wave_fzp.y,
                          torch.ones_like(wave_fzp.state))
    rN = fzp.limPhysX[1]
    dim = np.linspace(-0.2 * rN, 0.2 * rN, nfocus)
    focal, evs, stages = [], [], None
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    for mEs, mEp in modes:
        src = w0.replace(Es=mEs, Ep=mEp, Jss=(mEs * torch.conj(mEs)).real,
                         Jpp=(mEp * torch.conj(mEp)).real,
                         Jsp=mEs * torch.conj(mEp),
                         state=torch.ones_like(w0.state))
        ev = events(3)
        ev[0].record()
        b = W.diffract(src, wave_fzp, **C5_HOP)
        ev[1].record()
        masked = b.replace(state=zmask)
        f = scr.expose_wave(masked, dim, dim, **C5_HOP)
        ev[2].record()
        # (nz, nx) -> (nx, nz): x the first axis of the stack's fields
        focal.append(torch.stack([f.Es, f.Ep]).reshape(
            2, nfocus, nfocus).transpose(1, 2))
        evs.append(ev)
        if stages is None:
            stages = [(src, wave_fzp), (masked, W.prepare_wave_on_screen(
                scr, fzp, dim, dim, dtype=dtype, device='cuda'))]
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    stack = torch.stack(focal)          # (modes, 2, nx, nz)
    I = (torch.abs(stack) ** 2).sum(dim=(0, 1))
    return dict(wAll=wAll, flux=flux, dotc_slit=dotc_slit, zmask=zmask,
                wave_fzp=wave_fzp, U=stack[:, 0], I=I, dim=dim, rN=rN,
                fzp=fzp, slit=slit, und=und, w0=w0, stages=stages,
                evs=evs, t=(t0, t1, t2, t3, t4))


@contextlib.contextmanager
def recorded_b1(store, ndst):
    """Record every launch of kernel B1 inside the block: the last *ndst*
    destinations' inputs and sums, the (unpadded) sources and the scalars,
    for a check against the plain version afterwards."""
    from xrt_tpu_torch.ops import kirchhoff as tk
    rows_launch = tk._launch_rows

    def rows_rec(scheme, variant, D, rows, P, nsrc):
        out = rows_launch(scheme, variant, D, rows, P, nsrc)
        if scheme == 'recentred':
            nsk = len(tk._RECENTRED_KEYS[variant][1])
            store.append((D[:, -ndst:].clone(), rows[:nsrc, :nsk].t(), P,
                          variant, out[:, -ndst:].clone(), D.shape[1]))
        return out
    tk._launch_rows = rows_rec
    try:
        yield
    finally:
        tk._launch_rows = rows_launch


def profiled_kernel_count(fn):
    """The number of device kernels *fn* launches, by torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def c5_focal_concentration(res):
    """(centre peak, outer mean) of the focal intensity: the largest
    pixel within 0.02 rN of the axis and the mean beyond 0.1 rN."""
    import numpy as np
    import torch
    d = torch.as_tensor(res['dim'], dtype=res['I'].dtype,
                        device=res['I'].device)
    r = torch.sqrt(d[:, None] ** 2 + d[None, :] ** 2)
    I = res['I']
    return (float(I[r < 0.02 * res['rN']].max()),
            float(I[r > 0.1 * res['rN']].mean()))


def phase_coherent_modes(timing):
    """Phase 18: BASELINE configuration 5's coherent modes at full width,
    float32, and the coherence analysis of the focal stack."""
    import numpy as np
    import torch
    from xrt_tpu_torch import coherence as tc, waves as W
    from xrt_tpu_torch.ops import kirchhoff as tk
    ne, nslit, nfzp, nfoc = C5_ELECTRONS, C5_NSLIT, C5_NFZP, C5_NFOCUS
    c5_run(torch.float32, 4, 2000, 2000, 16)       # warm-up
    # launches of one filament (the undulator's integral, plain PyTorch)
    und, slit, _, _ = config5_line(torch.float32)
    w_ = slit.propagate_wave(None, nrays=nslit, prevOE=und,
                             fixedEnergy=C5_E0,
                             generator=torch.Generator().manual_seed(1))
    nk = profiled_kernel_count(lambda: und.shine_wave(
        torch.Generator().manual_seed(2), w_, C5_E0))
    del w_
    rec = []
    torch.cuda.reset_peak_memory_stats()
    tk.LAUNCHES.clear()
    with recorded_b1(rec, C5_CHECK_DST):
        res = c5_run(torch.float32, ne, nslit, nfzp, nfoc)
    torch.cuda.synchronize()
    launches = dict(tk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    t0, t1, t2, t3, t4 = res['t']
    hop = [(e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2]))
           for e in res['evs']]
    pairs = C5_MODES * (nfzp * nslit + nfoc * nfoc * nfzp)
    w = res['wAll'].double().cpu().numpy()[::-1]
    print(f'phase 18 configuration 5: {ne} filaments x {nslit} slit '
          f'samples (float32): {(t1 - t0) * 1e3:.1f} ms, '
          f'{(t1 - t0) * 1e3 / ne:.2f} ms and {nk} kernel launches a '
          f'filament (torch.profiler), solve_modes {(t2 - t1) * 1e3:.1f} '
          f'ms; {C5_MODES} modes slit -> zone plate ({nfzp} samples) -> '
          f'{nfoc}x{nfoc} focus: {(t4 - t3) * 1e3:.1f} ms, '
          f'{pairs:.4e} pairs, {pairs / (t4 - t3):.3e} pairs/s; whole '
          f'{(t4 - t0) * 1e3:.1f} ms; peak device memory '
          f'{peak / 2 ** 30:.2f} GiB; launches {launches}', flush=True)
    for i, (a, b) in enumerate(hop):
        print(f'phase 18 mode {i}: weight {w[i]:.6f}, slit -> zone plate '
              f'{a:.2f} ms, zone plate -> focus {b:.2f} ms (CUDA events)',
              flush=True)
    check(launches == {'kirchhoff_recentred:mono': 2 * C5_MODES,
                       'prep:mono': 2 * C5_MODES},
          f'configuration 5: B1 launches {launches}')
    check(abs(w.sum() - 1) < 1e-4 and w[0] > 0.25 and w[0] > 1.2 * w[1],
          f'configuration 5 mode weights {w[:4]}, sum {w.sum()}')
    # the zone mask: open fraction, float32 against float64 on the same
    # samples
    fzp64 = config5_line(torch.float64)[2]
    wf64 = W.prepare_wave_on_oe(fzp64, res['slit'], nfzp,
                                generator=torch.Generator().manual_seed(51),
                                dtype=torch.float64, device='cuda')
    open32 = float((res['zmask'] == 1).double().mean())
    open64 = float((fzp64.rays_good(wf64.x, wf64.y, torch.ones_like(
        wf64.state)) == 1).double().mean())
    centre, outer = c5_focal_concentration(res)
    dotc_w = float((res['wAll'].double() ** 2).sum())
    print(f'phase 18 zone mask: open fraction {open32:.6f} (float64 on the '
          f'same samples {open64:.6f}, {abs(open32 - open64):.2e}; limit '
          f'1e-3); focal centre {centre:.6e} vs outer mean {outer:.6e} '
          f'({centre / outer:.1f}x, limit 5x); DoTC of the slit stack '
          f'{res["dotc_slit"]:.8f} vs sum of squared weights {dotc_w:.8f}',
          flush=True)
    check(0.2 < open32 < 0.8 and abs(open32 - open64) < 1e-3,
          f'zone mask open fraction {open32} / {open64}')
    check(centre > 5 * outer, f'focal concentration {centre} / {outer}')
    check(abs(res['dotc_slit'] - dotc_w) < 1e-4,
          f'slit DoTC {res["dotc_slit"]} vs sum w^2 {dotc_w}')
    # the coherence analysis of the focal stack of the propagated modes
    U = res['U']
    axis = torch.as_tensor(res['dim'], dtype=torch.float32, device='cuda')
    torch.cuda.synchronize()
    ta = time.perf_counter()
    dotc = float(tc.calc_degree_of_transverse_coherence_PCA(U))
    wf, _ = tc.calc_eigen_modes_PCA(U, eigenN=C5_MODES)
    cfx = tc.calc_1D_coherent_fraction(U, 'x', axis)
    cfz = tc.calc_1D_coherent_fraction(U, 'z', axis)
    doc, ref = tc.degree_of_coherence_map(U.reshape(C5_MODES, -1))
    torch.cuda.synchronize()
    tb = time.perf_counter()
    wf = wf.double().cpu().numpy()[::-1]
    print(f'phase 18 focal coherence ({(tb - ta) * 1e3:.1f} ms): DoTC '
          f'{dotc:.6f}; focal mode weights {np.round(wf / wf.sum(), 6)}; '
          f'coherent fraction x {float(cfx[6]):.6f} (limDoC {cfx[5]}), z '
          f'{float(cfz[6]):.6f} (limDoC {cfz[5]}); DoC map at the peak '
          f'pixel {ref}: mean {float(doc.mean()):.6f}', flush=True)
    check(0 < dotc <= 1 + 1e-5 and all(0 < float(c[6]) <= 1 + 1e-5
                                       for c in (cfx, cfz)) and
          abs(float(doc[ref]) - 1) < 1e-4, 'focal coherence analysis')
    # every B1 launch of the run against the plain version on the last
    # destinations
    worst = 0.0
    for D, S, P, v, out, _ in rec:
        ref_rows = tk._plain_rows('recentred', v, D, S, P)
        rel, _ = rel_err(tk._complex5(out), tk._complex5(ref_rows))
        worst = max(worst, rel)
    print(f'phase 18 the {len(rec)} B1 launches against the plain version '
          f'on their last {C5_CHECK_DST} destinations: max rel {worst:.2e} '
          f'(limit 2e-5)', flush=True)
    check(len(rec) == 2 * C5_MODES and worst < 2e-5,
          f'configuration 5 B1 against plain: {worst:.3e}')
    shapes = collections.Counter((r[5], r[1].shape[1]) for r in rec)
    timing['config5'] = dict(launches=launches, stages=res['stages'],
                             shape_launches=shapes)
    del res, rec, U

    # float32 against float64: the whole path at a cut size
    cross = {dt: c5_run(dt, **C5_CROSS) for dt in (torch.float32,
                                                    torch.float64)}
    r32, r64 = cross[torch.float32], cross[torch.float64]
    w32 = r32['wAll'].double().cpu().numpy()[::-1][:C5_MODES]
    w64 = r64['wAll'].double().cpu().numpy()[::-1][:C5_MODES]
    ew = float(np.max(np.abs(w32 / w64 - 1)))
    I32, I64 = r32['I'].double(), r64['I']
    eI = float((I32 - I64).abs().max() / I64.max())
    print(f'phase 18 float32 vs float64 ({C5_CROSS}): the {C5_MODES} '
          f'largest weights to {ew:.2e} relative (limit 1e-3), focal '
          f'max|dI|/max I {eI:.2e} (limit 5e-3)', flush=True)
    check(ew < 1e-3 and eI < 5e-3, f'configuration 5 f32 vs f64: {ew}, '
          f'{eI}')


def config2_line(nrays, dtype):
    """BASELINE configuration 2 (tests/test_baseline_configs.py:54-81):
    bending magnet -> Rh toroid (15 m) -> slit -> screen (20 m)."""
    from xrt_tpu_torch.apertures import RectangularAperture
    from xrt_tpu_torch.materials import Material
    from xrt_tpu_torch.oes import ToroidMirror
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import BendingMagnet
    dk = dict(dtype=dtype, device='cuda')
    p, q, pitch = C2_P, C2_Q, C2_PITCH
    bm = BendingMagnet.create(
        nrays=nrays, eE=3.0, eI=0.5, B0=1.7, eEpsilonX=0.0, eEpsilonZ=0.0,
        eMin=C5_E0 - 50, eMax=C5_E0 + 50, xPrimeMax=0.2e-3,
        zPrimeMax=0.1e-3, **dk)
    tor = ToroidMirror.create(
        center=(0, p, 0), pitch=pitch, R=2 * p * q / (p + q) /
        math.sin(pitch), r=2 * p * q / (p + q) * math.sin(pitch),
        material=Material.create('Rh', rho=12.41, **dk),
        limPhysX=(-15, 15), limPhysY=(-400, 400))
    slit = RectangularAperture.create(
        center=(0, p + 1000.0, 2 * pitch * 1000.0),
        opening=(-5.0, 5.0, -5.0, 5.0))
    scr = Screen.create(center=(0, p + q, 2 * pitch * q))
    return bm, tor, slit, scr


def c2_pass(line, rng):
    """One pass of configuration 2: the screen image and the sums (good
    rays, sum x, x^2, z, z^2; flux, sum I x, I x^2, I z, I z^2), float64
    on the device."""
    import torch
    bm, tor, slit, scr = line
    glo = tor.reflect(bm.shine(rng), rng)[0]
    glo = slit.propagate(glo, needNewGlobal=True)[0]
    img = scr.expose(glo)
    good = (img.state == 1).double()
    I = torch.where(img.state == 1, img.Jss + img.Jpp,
                    torch.zeros_like(img.Jss)).double()
    x, z = img.x.double(), img.z.double()
    sums = torch.stack([w_ * v for w_ in (good, I)
                        for v in (torch.ones_like(x), x, x * x, z, z * z)]
                       ).sum(dim=1)
    return img, sums


def c2_moments(sums):
    """(good rays, mean x, std x, mean z, std z) unweighted and the same
    weighted by the intensity (flux in place of the rays), from the sums
    of c2_pass over passes."""
    import torch
    s = torch.stack(list(sums)).sum(0).tolist()
    out = []
    for n, sx, sxx, sz, szz in (s[:5], s[5:]):
        mx, mz = sx / n, sz / n
        out.append((n, mx, math.sqrt(max(sxx / n - mx * mx, 0.0)), mz,
                    math.sqrt(max(szz / n - mz * mz, 0.0))))
    return out


def c2_plot(bins=128):
    from xrt_tpu_torch.plotspec import XYCAxis, XYCPlot
    return XYCPlot(beam='screen', xaxis=XYCAxis('x', 'mm', bins=bins),
                   yaxis=XYCAxis('z', 'mm', bins=bins),
                   caxis=XYCAxis('energy', 'eV', bins=bins,
                                 limits=(C5_E0 - 50, C5_E0 + 50)))


def phase_config2(timing):
    """Phase 19: BASELINE configuration 2 at 1e7 rays a pass through
    run_ray_tracing; the bending magnet's and the wiggler's maps on the
    golden's points; a wiggler shine."""
    import os
    import numpy as np
    import torch
    from xrt_tpu_torch import histogram as th, runner
    from xrt_tpu_torch.sources import BendingMagnet, Wiggler
    n, reps = C2_NRAYS, C2_REPEATS
    line = config2_line(n, torch.float32)
    bm, tor, slit, scr = line
    entries, sums = [], []

    def run_process(beamLine, rng):
        torch.cuda.synchronize()
        entries.append(time.perf_counter())
        img, s = c2_pass(line, rng)
        sums.append(s)
        return {'screen': img}

    rng = torch.Generator('cuda').manual_seed(31)
    runner.run_ray_tracing(c2_plot(), repeats=1, run_process=run_process,
                           rng=rng)             # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    entries.clear()
    sums.clear()
    th.LAUNCHES.clear()
    plot = c2_plot()
    runner.run_ray_tracing(plot, repeats=reps, run_process=run_process,
                           rng=rng)
    torch.cuda.synchronize()
    launches = dict(th.LAUNCHES)
    t = entries + [time.perf_counter()]
    pass_ms = [1e3 * (b - a) for a, b in zip(t[:-1], t[1:])]
    med = statistics.median(pass_ms[1:])
    peak = torch.cuda.max_memory_allocated()
    print(f'phase 19 configuration 2: {n} rays/pass ({n * bm.oversample} '
          f'bending-magnet candidates), float32, {reps} passes + '
          f'calibration: {", ".join(f"{v:.1f}" for v in pass_ms)} ms, '
          f'median {med:.1f} ms, {n / (med * 1e-3):.3e} rays/s; peak '
          f'device memory {peak / 2 ** 30:.2f} GiB; launches {launches}',
          flush=True)
    check(launches == {f'hist_plot:{th.plot_route((128,) * 3)}': reps},
          f'configuration 2: not one hist_plot launch a pass: {launches}')
    for i, s in enumerate(sums):
        (ng, _, sx, _, sz), _ = c2_moments([s])
        print(f'phase 19 pass {i}: {int(ng)} rays through, footprint std x '
              f'{sx * 1e3:.4f} um, z {sz * 1e3:.3f} um (limits 300, 100 '
              f'um)', flush=True)
        check(ng > 0.1 * n and sx < 0.3 and sz < 0.1,
              f'configuration 2 footprint {ng}, {sx}, {sz}')
    # one pass split by CUDA events; the shine's candidates through
    # build_I_map alone; the search alone
    ms, (beam, glo, glo2, img, hists) = step_split([
        lambda: bm.shine(rng), lambda b: tor.reflect(b, rng)[0],
        lambda g: slit.propagate(g, needNewGlobal=True)[0],
        lambda g: scr.expose(g),
        lambda i: runner.histogram_plot(plot, {'screen': i})])
    M = n * bm.oversample
    g = torch.Generator('cuda').manual_seed(32)
    u = [torch.rand(M, generator=g, device='cuda') for _ in range(3)]
    cand = (u[0] * (bm.eMax - bm.eMin) + bm.eMin,
            u[1] * (bm.Theta_max - bm.Theta_min) + bm.Theta_min,
            u[2] * (bm.Psi_max - bm.Psi_min) + bm.Psi_min)
    imap_ms, _ = cuda_ms(lambda: bm._I_map_blocks(g, *cand))
    del u, cand
    s_ms, iters = search_alone(tor, beam)
    print(f'phase 19 split of one pass (CUDA events): shine {ms[0]:.1f} ms '
          f'(its {M} candidates through build_I_map alone {imap_ms:.1f} '
          f'ms; the rest, draws, resampling and positions, '
          f'{ms[0] - imap_ms:.1f} ms), reflect {ms[1]:.1f} ms (bracket + '
          f'search alone {s_ms:.1f} ms in {iters} Illinois iterations), '
          f'slit {ms[2]:.1f} ms, expose {ms[3]:.1f} ms, histograms '
          f'{ms[4]:.2f} ms', flush=True)
    x, y, cData, inten, fl, mask, _ = runner._plot_arrays(
        plot, {'screen': img})
    args = (x, y, cData, fl, inten, mask, (128, 128, 128),
            tuple(tuple(a.limits) for a in (plot.xaxis, plot.yaxis,
                                             plot.caxis)),
            plot.colorFactor, plot.colorSaturation)
    rel, same = plot_errors(th.hist_plot_kernel(*args),
                            th.hist_plot_plain(*args,
                                               sum_dtype=torch.float64))
    print(f'phase 19 hist_plot on a configuration-2 pass: eight '
          f'histograms vs plain float64 sums max rel {rel:.2e}, bins '
          f'identical {same}', flush=True)
    check(same and rel < 1e-5, f'configuration 2 hist_plot: {rel:.3e}')
    timing['config2'] = dict(launches=launches, plot_args=args)
    del beam, glo, glo2, img, hists

    # float32 against float64 on the same 2e5 rays (float64 draws)
    res = {}
    for dt in (torch.float32, torch.float64):
        _, s = c2_pass(config2_line(C2_CROSS_NRAYS, dt),
                       torch.Generator().manual_seed(5))
        res[dt] = c2_moments([s])[1]
    (f32, mx32, sx32, mz32, sz32) = res[torch.float32]
    (f64, mx64, sx64, mz64, sz64) = res[torch.float64]
    errs = (abs(f32 / f64 - 1), abs(mx32 - mx64) / sx64,
            abs(sx32 / sx64 - 1), abs(mz32 - mz64) / sz64,
            abs(sz32 / sz64 - 1))
    print(f'phase 19 configuration 2 float32 vs float64, {C2_CROSS_NRAYS} '
          f'rays: flux per ray {f32 / C2_CROSS_NRAYS:.6f} / '
          f'{f64 / C2_CROSS_NRAYS:.6f} ({errs[0]:.2e}), weighted means and '
          f'sizes x {errs[1]:.2e} / {errs[2]:.2e}, z {errs[3]:.2e} / '
          f'{errs[4]:.2e} (of the size; limit 1e-3)', flush=True)
    check(max(errs) < 1e-3, f'configuration 2 f32 vs f64 {errs}')

    # the bending magnet's and the wiggler's maps on the golden's points
    gold = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                SOURCES_GOLDEN))
    for name, make in (('bm', lambda dk: BendingMagnet.create(
            eE=6.0, eI=0.2, B0=0.85, eMin=10000, eMax=60000,
            xPrimeMax=1.0, zPrimeMax=0.3, **dk)),
            ('wig', lambda dk: Wiggler.create(
                eE=3.0, eI=0.5, K=13.0, period=150.0, n=10, eMin=1000,
                eMax=30000, xPrimeMax=1.0, zPrimeMax=0.3, **dk))):
        out = {}
        for dt in (torch.float32, torch.float64):
            src = make(dict(dtype=dt, device='cuda'))
            pts = [torch.as_tensor(gold[f'{name}_{k}'], dtype=dt,
                                   device='cuda')
                   for k in ('E', 'theta', 'psi')]
            out[dt] = [v.cpu().numpy() for v in src.build_I_map(None,
                                                                 *pts)]
        g64 = out[torch.float64]
        atol_I = 1e-3 if name == 'wig' else 0.0
        e_gold = max(
            float(np.max(np.abs(v - gold[f'{name}_{k}']) /
                         (3e-8 * np.abs(gold[f'{name}_{k}']) + atol)))
            for v, k, atol in ((g64[0], 'I', atol_I), (g64[1], 'Es', 1e-10),
                               (g64[2], 'Ep', 1e-10)))
        e32 = max(float(np.abs(a.astype(b.dtype) - b).max() /
                        np.abs(b).max())
                  for a, b in zip(out[torch.float32], g64))
        finite = all(np.isfinite(np.abs(a)).all()
                     for a in out[torch.float32])
        print(f'phase 19 {name} build_I_map at ref_sources.npz\'s 693 '
              f'points: float64 against the golden at its tolerances '
              f'(rtol 3e-8): {e_gold:.3f} of the allowed; float32 against '
              f'float64 {e32:.2e} (limit 1e-5), finite {finite}',
              flush=True)
        check(e_gold <= 1 and e32 < 1e-5 and finite,
              f'{name} maps: {e_gold}, {e32}, finite {finite}')
    wig = Wiggler.create(nrays=1_000_000, eE=3.0, eI=0.5, K=13.0,
                         period=150.0, n=10, eMin=1000, eMax=30000,
                         xPrimeMax=1.0, zPrimeMax=0.3, dtype=torch.float32,
                         device='cuda')
    wr = torch.Generator('cuda').manual_seed(33)
    wig.shine(wr)
    wms, wb = cuda_ms(lambda: wig.shine(wr))
    check(bool(torch.isfinite(wb.Jss).all()) and float(wb.accepted) > 0,
          'wiggler shine')
    print(f'phase 19 wiggler shine: 1e6 rays (2e6 candidates), float32, '
          f'{wms:.1f} ms (CUDA events)', flush=True)


def phase_field_maps():
    """Phase 20: the undulator's and the bending magnet's field maps on
    their auto meshes."""
    import numpy as np
    import torch
    from xrt_tpu_torch.sources import BendingMagnet, Undulator

    def und(dt):
        return Undulator.create(
            eE=3.0, eI=0.5, period=18.0, n=111, targetE=(C5_E0, 7),
            eEspread=8e-4, eEpsilonX=0.263, eEpsilonZ=0.008, betaX=9.0,
            betaZ=2.0, eMin=C5_E0 - 40, eMax=C5_E0 + 40, xPrimeMax=0.02,
            zPrimeMax=0.02, gNodes=64, dtype=dt, device='cuda')

    def bm(dt):
        return BendingMagnet.create(
            eE=3.0, eI=0.5, B0=1.7, eMin=C5_E0 - 50, eMax=C5_E0 + 50,
            xPrimeMax=0.2, zPrimeMax=0.1, dtype=dt, device='cuda')
    u32 = und(torch.float32)
    u32.intensities_on_mesh(energy=np.array([C5_E0]))      # warm-up
    rows = []
    for name, fn in (
            ('undulator Stokes', lambda: u32.intensities_on_mesh()),
            ('undulator vortex', lambda: u32.intensities_on_mesh(
                resultKind='vortex')),
            ('undulator multi_electron_stack', lambda: u32.
             multi_electron_stack(torch.Generator('cuda').manual_seed(3))),
            ('bending magnet Stokes', lambda: bm(
                torch.float32).intensities_on_mesh())):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        shape = tuple(out[0].shape)
        finite = all(np.isfinite(np.asarray(o.cpu() if hasattr(o, 'cpu')
                                            else o)).all() for o in out)
        rows.append((name, ms, shape, finite))
        print(f'phase 20 {name}: {shape}, {ms:.1f} ms (host clock, '
              f'synchronized; the field on the card, the Stokes / '
              f'angular-momentum terms, the energy-spread average and the '
              f'convolution on the host), finite {finite}', flush=True)
        check(finite, f'{name} not finite')
    npts = 65 * 33 * 33 * 36
    print(f'phase 20 the undulator map: {npts} points (65 x 33 x 33 x 36 '
          f'energy-spread samples) through the 64-node integral',
          flush=True)
    for name, make in (('undulator', und), ('bending magnet', bm)):
        s32 = make(torch.float32).intensities_on_mesh()[0]
        s64 = make(torch.float64).intensities_on_mesh()[0]
        e = float(np.abs(s32 - s64).max() / np.abs(s64).max())
        print(f'phase 20 {name} s0 float32 vs float64: max|d| / max '
              f'{e:.2e} (limit {MAP_F32_LIMIT:g})', flush=True)
        check(e < MAP_F32_LIMIT, f'{name} map f32 vs f64: {e}')


def coherence_rows(timing):
    """The kernels' rows on the coherence slice's paths: B1 at the two hop
    shapes of configuration 5 (phase 18's launches) and ``hist_plot`` on
    a configuration-2 pass (phase 19's)."""
    import torch
    from xrt_tpu_torch import histogram as th
    c5 = timing['config5']
    rows = []
    name, variant = 'kirchhoff_recentred', 'mono'
    key = f'{name}:{variant}'
    for hop, stage in zip(('slit-zoneplate', 'zoneplate-focus'),
                          c5['stages']):
        ms, plain_ms, ab, rel, Nd, Ns, _ = time_kernel(name, variant,
                                                       stage)
        bms, by = bound_ms(key, Nd, Ns)
        launches = int(c5['shape_launches'].get((Nd, Ns), 0))
        print(f'phase 5 {key}:config5-{hop}: {Nd} x {Ns} pairs, kernel '
              f'{ms:.2f} ms, plain {plain_ms:.1f} ms, bound {bms:.2f} ms '
              f'({by}), {bms / ms:.1%} of bound, '
              f'{Nd * Ns / (ms * 1e-3):.3e} pairs/s, max rel {rel:.2e}, '
              f'launches {launches}', flush=True)
        check(rel < 2e-5, f'{key} at configuration 5 {hop}: {rel:.3e}')
        check(launches == C5_MODES, f'{key} {hop}: {launches} launches')
        rows.append(dict(name=f'{key}:config5-{hop}', route='cuda',
                         source=SOURCES[name], replaces=REPLACES[name],
                         launches=launches, max_abs_err=ab,
                         max_rel_err=rel, ms=ms, plain_ms=plain_ms,
                         bound_ms=bms, bound_by=by, library_ms=None,
                         shape=f'{Nd}x{Ns}'))
    args = timing['config2']['plot_args']
    route = th.plot_route((128,) * 3)
    kernel = lambda: th.hist_plot_kernel(*args)  # noqa: E731
    kernel()
    torch.cuda.synchronize()
    ms = statistics.median(cuda_ms(kernel, 5)[0] for _ in range(3))
    got = kernel()
    plain_ms, _ = cuda_ms(lambda: th.hist_plot_plain(*args))
    ref = th.hist_plot_plain(*args, sum_dtype=torch.float64)
    rel, _ = plot_errors(got, ref)
    ab = max(float((got[k].double() - ref[k]).abs().max())
             for k in th.PLOT_HISTS)
    n = args[0].shape[0]
    bms = 1e3 * (21.0 * n + 4.0 * (4 * (3 * 128 + 128 * 128) + 1)) / \
        PEAK_BYTES
    launches = int(timing['config2']['launches'].get(f'hist_plot:{route}',
                                                     0))
    print(f'phase 5 hist_plot:config2: {n} rays of a configuration-2 pass '
          f'into eight histograms ({route}), kernel {ms:.4f} ms, plain '
          f'{plain_ms:.2f} ms, bound {bms:.4f} ms (bytes), launches '
          f'{launches}', flush=True)
    rows.append(dict(name='hist_plot:config2', route='cuda',
                     source=SOURCES['hist_plot'],
                     replaces=REPLACES['hist_plot'], launches=launches,
                     max_abs_err=ab, max_rel_err=rel, ms=ms,
                     plain_ms=plain_ms, bound_ms=bms, bound_by='bytes',
                     library_ms=None))
    check(launches > 0, 'hist_plot:config2 was not launched on its path')
    return rows

# ---------------------------------------------------------------------------
# the rest of the OE physics: Takagi-Taupin and Laue crystals, refractive
# lenses, multilayers and powders
# ---------------------------------------------------------------------------

#: rays a pass and passes of phases 21-24, and the float32 / float64
#: cross-checks' rays
OE_NRAYS, OE_REPEATS, OE_CROSS_NRAYS = 1_000_000, 4, 200_000
#: examples/04_bent_crystal_tt.py: energy, radii (mm), angles, steps
TT_E0, TT_RADII, TT_NANGLES, TT_NSTEPS = 9000.0, \
    (math.inf, 5000.0, 2000.0, 1000.0), 201, 4000
TT_GOLDEN = 'tests/golden/ref_tt.npz'
#: examples/13_laue_mono.py: energy, distance, bending radius, band
LAUE_E0, LAUE_P, LAUE_R, LAUE_DE = 60000.0, 10000.0, 2000.0, 600.0
#: the reference package's own float32 error of the Laue monochromator's flux
#: per ray and weighted mean energy (eV) against float64, on the CPU at 3000
#: rays (tests/test_torch_laue.py), and the limits held on the card: about
#: twice the port's own reading there at OE_CROSS_NRAYS rays (9.11e-3,
#: 2.08 eV on an H100 80GB HBM3 at 700 W)
LAUE_F32_REF, LAUE_F32_CARD = (8.64e-2, 82.0), (1.9e-2, 4.2)
#: tests/test_bentlaue2d.py's volumetric crystal
VD_E0, VD_RM, VD_RS = 40000.0, 2000.0, -10000.0
#: examples/14_lenses_crl.py
CRL_E0, CRL_P, CRL_F = 9000.0, 10000.0, 3000.0
#: examples/10_multilayer.py
ML_E0, ML_P, ML_Q = 8050.0, 10000.0, 2000.0
#: examples/15_xrd_powder.py
PW_E0, PW_A, PW_P, PW_D = 8047.8, 5.430710, 1000.0, 150.0


def oe_passes(process, plot_fn, reps, seed, warm=True):
    """A warm-up run of one pass (with *warm*), then *reps* passes through
    run_ray_tracing: (plot, pass ms with the calibration pass first, the
    median of the others, histogram launches, peak device memory, the
    generator)."""
    import torch
    from xrt_tpu_torch import histogram as th, runner
    entries = []

    def run_process(beamLine, rng):
        torch.cuda.synchronize()
        entries.append(time.perf_counter())
        return process(rng)
    rng = torch.Generator('cuda').manual_seed(seed)
    if warm:
        runner.run_ray_tracing(plot_fn(), repeats=1,
                               run_process=run_process, rng=rng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    entries.clear()
    th.LAUNCHES.clear()
    plot = plot_fn()
    runner.run_ray_tracing(plot, repeats=reps, run_process=run_process,
                           rng=rng)
    torch.cuda.synchronize()
    t = entries + [time.perf_counter()]
    pass_ms = [1e3 * (b - a) for a, b in zip(t[:-1], t[1:])]
    peak = torch.cuda.max_memory_allocated()
    return (plot, pass_ms, statistics.median(pass_ms[1:]),
            dict(th.LAUNCHES), peak, rng)


def oe_hist_plot_check(phase, label, plot, beams):
    """The phase's ``hist_plot`` against ``hist_plot_plain`` with float64
    sums on one pass's rays: max|h - h64| / max|h64| < 1e-5 and the same
    non-empty, NaN and infinite bins (plot_errors).  Returns the kernel's
    arguments."""
    import torch
    from xrt_tpu_torch import histogram as th, runner
    x, y, cData, inten, fl, mask, _ = runner._plot_arrays(plot, beams)
    bins = (plot.xaxis.bins, plot.yaxis.bins, plot.caxis.bins)
    args = (x, y, cData, fl, inten, mask, bins,
            tuple(tuple(a.limits) for a in (plot.xaxis, plot.yaxis,
                                             plot.caxis)),
            plot.colorFactor, plot.colorSaturation)
    got = th.hist_plot_kernel(*args)
    ref = th.hist_plot_plain(*args, sum_dtype=torch.float64)
    rel, same = plot_errors(got, ref)
    emptied = sum(int(((got[k] == 0) & (ref[k] != 0) &
                       torch.isfinite(ref[k])).sum())
                  for k in th.PLOT_HISTS + ('intensity',))
    print(f'phase {phase} hist_plot on a {label} pass: eight histograms '
          f'vs plain float64 sums max rel {rel:.2e} (limit 1e-5), bins '
          f'identical {same}, bins the float sums fill and the kernel '
          f'leaves empty {emptied}', flush=True)
    check(same and rel < 1e-5, f'{label} hist_plot: {rel:.3e}, bins '
          f'identical {same}, {emptied} emptied')
    return args


def oe_plot(x, z, c):
    from xrt_tpu_torch.plotspec import XYCAxis, XYCPlot
    return XYCPlot(beam='screen', xaxis=XYCAxis(**x, bins=128),
                   yaxis=XYCAxis(**z, bins=128), caxis=XYCAxis(**c, bins=128))


def tt_launch_count(si, E, bIn):
    """Kernel launches of one tt_amplitudes call at TT_NSTEPS steps: the
    profiler's counts at 50 and 100 steps give the launches a step and
    the fixed part."""
    from xrt_tpu_torch.materials import tt
    c1, c2, ir1 = tt.compute_tt_params(si, 0.0, Rm=2000.0, Rs=math.inf)
    n = [profiled_kernel_count(lambda: tt.tt_amplitudes(
        E, bIn, None, None, si, c1, c2, ir1, nsteps=s)) for s in (50, 100)]
    per_step = (n[1] - n[0]) / 50
    return per_step, n[0] - 50 * per_step


class _Timed:
    """Wraps a method of an object: CUDA events around each call, read
    after the pass."""

    def __init__(self, obj, name):
        self.obj, self.name = obj, name
        self.orig = getattr(obj, name)
        self.own = name in vars(obj)
        self.pairs = []

    def __enter__(self):
        def timed(*a, **k):
            ev = events(2)
            ev[0].record()
            out = self.orig(*a, **k)
            ev[1].record()
            self.pairs.append(ev)
            return out
        setattr(self.obj, self.name, timed)
        return self

    def __exit__(self, *exc):
        if self.own:
            setattr(self.obj, self.name, self.orig)
        else:
            delattr(self.obj, self.name)

    def ms(self):
        import torch
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def laue_mono_line(nrays, dtype):
    """examples/13_laue_mono.py: GeometricSource (60 keV +- 600 eV flat,
    dz' 6e-4) -> Si(111) 'Laue reflected', 0.7 mm, useTT, on a
    BentLaueCylinder (R = 2 m) at 10 m -> screen 2 m downstream."""
    from xrt_tpu_torch.materials import CrystalSi
    from xrt_tpu_torch.oes import BentLaueCylinder
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import GeometricSource
    dk = dict(dtype=dtype, device='cuda')
    cr = CrystalSi.create(hkl=(1, 1, 1), t=0.7, geom='Laue reflected',
                          useTT=True, **dk)
    thetaB = float(cr.get_Bragg_angle(LAUE_E0))
    mono = BentLaueCylinder.create(
        R=LAUE_R, center=(0, LAUE_P, 0), pitch=math.pi / 2 + thetaB,
        material=cr, limPhysX=(-20, 20), limPhysY=(-20, 20))
    src = GeometricSource.create(
        nrays=nrays, dx=0.1, dz=0.1, dxprime=1e-5, distzprime='flat',
        dzprime=6e-4, distE='flat', energies=(LAUE_E0 - LAUE_DE,
                                              LAUE_E0 + LAUE_DE),
        polarization='horizontal', **dk)
    scr = Screen.create(center=(0, LAUE_P + 2000.0 * math.cos(2 * thetaB),
                                -2000.0 * math.sin(2 * thetaB)))
    return src, mono, scr


def flux_energy_sums(g):
    """(rays, sum I, sum I E) of a beam's good rays, float64 on the
    device."""
    import torch
    I = torch.where(g.state == 1, g.Jss + g.Jpp,
                    torch.zeros_like(g.Jss)).double()
    return torch.stack([torch.full_like(I[0], g.E.shape[0]), I.sum(),
                        (I * g.E.double()).sum()])


def phase_tt(timing):
    """Phase 21: bent crystals by Takagi-Taupin integration and Laue
    optics."""
    import numpy as np
    import os
    import torch
    from xrt_tpu_torch import histogram as th, runner
    from xrt_tpu_torch.materials import CrystalSi, tt
    from xrt_tpu_torch.oes import BentLaue2D, LauePlate
    from xrt_tpu_torch.sources import GeometricSource
    f64, f32 = torch.float64, torch.float32
    # (a) examples/04_bent_crystal_tt.py
    si = {dt: CrystalSi.create(hkl=(1, 1, 1), t=0.1, dtype=dt, device='cuda')
          for dt in (f32, f64)}
    thetaB = float(si[f64].get_Bragg_angle(TT_E0))
    scan = torch.linspace(-50e-6, 150e-6, TT_NANGLES, dtype=f64, device='cuda')
    bIn = {f64: -torch.sin(thetaB + scan)}
    bIn[f32] = bIn[f64].float()
    E = {dt: torch.full((TT_NANGLES,), TT_E0, dtype=dt, device='cuda')
         for dt in (f32, f64)}
    dth = float(scan[1] - scan[0]) * 1e6
    si[f32].get_amplitude_pytte(E[f32], bIn[f32], Ry=2000.0, nsteps=20)
    for Rm in TT_RADII:
        R, ms = {}, {}
        for dt in (f32, f64):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rs, _ = si[dt].get_amplitude_pytte(E[dt], bIn[dt], Ry=Rm,
                                               alphaAsym=0.0,
                                               nsteps=TT_NSTEPS)
            R[dt] = (rs.abs() ** 2).double()
            torch.cuda.synchronize()
            ms[dt] = 1e3 * (time.perf_counter() - t0)
        e32 = float((R[f32] - R[f64]).abs().max() / R[f64].max())
        tag = 'flat' if math.isinf(Rm) else f'Rm = {Rm / 1000:g} m'
        peakR = float(R[f64].max())
        print(f'phase 21 Si(111) 0.1 mm {tag}: peak R {peakR:.4f}, '
              f'integrated {float(R[f64].sum()) * dth:.4f} urad; '
              f'{TT_NANGLES} angles, {TT_NSTEPS} steps: float32 '
              f'{ms[f32]:.1f} ms, float64 {ms[f64]:.1f} ms (host clock, '
              f'synchronized); float32 vs float64 max|dR|/R_peak '
              f'{e32:.2e}', flush=True)
        check(bool(torch.isfinite(R[f32]).all()) and e32 < 0.05,
              f'TT {tag} float32: {e32}')
    per_step, fixed = tt_launch_count(si[f32], E[f32], bIn[f32])
    tt_launches = fixed + TT_NSTEPS * per_step
    print(f'phase 21 tt_amplitudes launches (torch.profiler at 50 and 100 '
          f'steps): {per_step:.1f} a step + {fixed:.0f}, '
          f'{tt_launches:.0f} at {TT_NSTEPS} steps', flush=True)
    # float64 against pyTTE's curves
    gold = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                TT_GOLDEN))
    gscan = torch.as_tensor(gold['scan'], dtype=f64, device='cuda')
    gE = torch.full(gscan.shape, float(gold['E0']), dtype=f64, device='cuda')
    th_ = float(gold['thetaB']) + gscan
    Rm = float(gold['Rm_mm'])
    worst = 0.0
    for geom, atol, ns in (('Bragg reflected', 1e-4, 4000),
                           ('Laue reflected', 1e-2, 8000)):
        cr = CrystalSi.create(hkl=(1, 1, 1), t=float(gold['t_mm']),
                              geom=geom, dtype=f64, device='cuda')
        args = (-torch.sin(th_),) if geom.startswith('B') else \
            (-torch.cos(th_), -torch.cos(th_), torch.sin(th_))
        for tag, Rx in (('', None), ('_sph', Rm), ('_acl', -Rm)):
            rs, rp = cr.get_amplitude_pytte(gE, *args, Ry=Rm, Rx=Rx,
                                            alphaAsym=0.0, nsteps=ns)
            for pol, r in (('sigma', rs), ('pi', rp)):
                key = f'{geom[:5].lower().strip()}_{pol}{tag}_R'
                err = float(np.abs((r.abs() ** 2).cpu().numpy() -
                                   gold[key].real).max())
                worst = max(worst, err / atol)
                check(err <= atol, f'TT {key}: {err} > {atol}')
    print(f'phase 21 float64 against ref_tt.npz (pyTTE; Bragg atol 1e-4, '
          f'Laue 1e-2; cylindrical, spherical, anticlastic; sigma, pi): '
          f'worst {worst:.3f} of the allowed', flush=True)
    # d(integrated R) / d(1/R) by autograd against a central difference
    cr = si[f64]
    c1_0, c2_0, _ = tt.compute_tt_params(cr, 0.0, Rm=2000.0, Rs=math.inf)

    def integrated(invR):
        rs, _ = tt.tt_amplitudes(E[f64], bIn[f64], None, None, cr,
                                 c1_0 * invR * 2e6, c2_0 * invR * 2e6,
                                 invR, nsteps=1500, autoLimits=False)
        return torch.sum(rs.abs() ** 2)
    invR = torch.tensor(5e-7, dtype=f64, device='cuda', requires_grad=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    integrated(invR).backward()
    grad = float(invR.grad)
    gms = 1e3 * (time.perf_counter() - t0)
    with torch.no_grad():
        fd = (float(integrated(5e-7 + 1e-9)) -
              float(integrated(5e-7 - 1e-9))) / 2e-9
    print(f'phase 21 d(integrated R)/d(1/R), 1500 steps: autograd {grad:.6e}'
          f', central difference {fd:.6e} ({abs(grad / fd - 1):.2e}; limit '
          f'2e-2); forward + backward {gms:.0f} ms', flush=True)
    check(abs(grad / fd - 1) < 2e-2, f'TT gradient {grad} vs {fd}')

    # (b) the bent-Laue monochromator
    n, reps = OE_NRAYS, OE_REPEATS
    src, mono, scr = laue_mono_line(n, f32)

    def process(rng):
        glo = mono.reflect(src.shine(rng), rng)[0]
        return {'screen': scr.expose(glo)}

    def plot_fn():
        return oe_plot(dict(label='x', unit='mm', limits=(-2, 2)),
                       dict(label='z', unit='mm'),
                       dict(label='energy', unit='keV'))
    # no warm-up run: nothing is compiled, and a pass is ~4 s of
    # Takagi-Taupin steps (the calibration pass is not in the median)
    plot, pass_ms, med, launches, peak, rng = oe_passes(process, plot_fn,
                                                        reps, 41, warm=False)
    print(f'phase 21 bent-Laue monochromator (Si(111) 0.7 mm, R = 2 m, '
          f'useTT, {LAUE_E0 / 1e3:g} keV +- {LAUE_DE:g} eV): {n} rays/pass, '
          f'float32, {reps} passes + calibration: '
          f'{", ".join(f"{v:.1f}" for v in pass_ms)} ms, median {med:.1f} '
          f'ms, {n / (med * 1e-3):.3e} rays/s; nGood {plot.nRaysGood}, flux '
          f'{plot.intensity:.6g}, dE {plot.dE * 1e3:.4g} eV; peak device '
          f'memory {peak / 2 ** 30:.2f} GiB; launches {launches}', flush=True)
    route = th.plot_route((128,) * 3)
    check(launches == {f'hist_plot:{route}': reps},
          f'Laue mono: not one hist_plot launch a pass: {launches}')
    check(plot.nRaysGood > 0 and plot.intensity > 0, 'Laue mono: no flux')
    with _Timed(mono.material, 'get_amplitude_pytte') as tamp:
        ms, (beam, glo, img, hists) = step_split([
            lambda: src.shine(rng), lambda b: mono.reflect(b, rng)[0],
            lambda g: scr.expose(g),
            lambda i: runner.histogram_plot(plot, {'screen': i})])
    s_ms, iters = search_alone(mono, beam)
    tt_ms = tamp.ms()
    print(f'phase 21 split of a Laue pass (CUDA events): source {ms[0]:.1f} '
          f'ms, reflect {ms[1]:.1f} ms (bracket + search alone {s_ms:.1f} ms '
          f'in {iters} Illinois iterations; TT amplitudes {tt_ms:.1f} ms, '
          f'{tt_launches:.0f} launches), expose {ms[2]:.1f} ms, histograms '
          f'{ms[3]:.2f} ms', flush=True)
    args = oe_hist_plot_check(21, 'Laue', plot, {'screen': img})
    timing['laue'] = dict(launches=launches, plot_args=args)
    del beam, glo, img, hists
    res = {}
    for dt in (f32, f64):
        s_, m_, _ = laue_mono_line(OE_CROSS_NRAYS, dt)
        g = m_.reflect(s_.shine(torch.Generator().manual_seed(5)))[0]
        nr, fl, fE = flux_energy_sums(g).tolist()
        res[dt] = (fl / nr, fE / fl)
    ef = abs(res[f32][0] / res[f64][0] - 1)
    eE = abs(res[f32][1] - res[f64][1])
    print(f'phase 21 Laue mono float32 vs float64, {OE_CROSS_NRAYS} rays: '
          f'flux per ray {res[f32][0]:.6e} / {res[f64][0]:.6e} ({ef:.2e}; '
          f'limit {LAUE_F32_CARD[0]:.1e}; the reference package\'s own '
          f'float32 on the CPU {LAUE_F32_REF[0]:.2e}), weighted mean E '
          f'{eE:.3f} eV (limit {LAUE_F32_CARD[1]:g} eV; the reference '
          f'package\'s {LAUE_F32_REF[1]:g} eV)', flush=True)
    check(ef <= LAUE_F32_CARD[0] and eE <= LAUE_F32_CARD[1],
          f'Laue mono float32 vs float64: {ef}, {eE}')

    # (c) volumetric diffraction in a 2D-bent Laue crystal
    dk = dict(dtype=f32, device='cuda')
    cr = CrystalSi.create(hkl=(1, 1, 1), t=0.2, geom='Laue reflected',
                          volumetricDiffraction=True, **dk)
    thB = float(cr.get_Bragg_angle(VD_E0))
    geo = dict(center=(0, 1000.0, 0), pitch=thB + math.pi / 2,
               limPhysX=(-10, 10), limPhysY=(-10, 10))
    oe = BentLaue2D.create(Rm=VD_RM, Rs=VD_RS, material=cr, **geo)
    flat = LauePlate.create(material=CrystalSi.create(
        hkl=(1, 1, 1), t=0.2, geom='Laue reflected', **dk), **geo)
    vsrc = GeometricSource.create(nrays=n, dzprime=1e-4, energies=(VD_E0,),
                                  distE='lines', **dk)
    beam = vsrc.shine(torch.Generator('cuda').manual_seed(7))
    g = torch.Generator('cuda').manual_seed(8)
    oe.reflect(beam, g)
    vms, (vglo, _) = cuda_ms(lambda: oe.reflect(beam, g))
    fglo = flat.reflect(beam)[0]
    fv, ff = (float(torch.where(b.state == 1, b.Jss + b.Jpp,
                                torch.zeros_like(b.Jss)).double().sum())
              for b in (vglo, fglo))
    print(f'phase 21 BentLaue2D with volumetric diffraction (Rm 2 m, Rs '
          f'-10 m, 0.2 mm, 40 keV): {n} rays, one reflect {vms:.1f} ms (CUDA '
          f'events); integrated flux {fv:.6g} against the flat LauePlate\'s '
          f'{ff:.6g}', flush=True)
    check(fv > ff > 0, f'volumetric flux {fv} <= flat {ff}')


def crl_line(nrays, dtype, nCRL=None):
    """examples/14_lenses_crl.py: a flat 0.5 x 0.5 mm parallel beam at 9
    keV -> Be ParaboloidFlatLens stack (focus 0.1 mm, zmax 1 mm, t 0.05
    mm, nCRL for f = 3 m) at 10 m -> screen at the thin-lens focus."""
    from xrt_tpu_torch.materials import Material
    from xrt_tpu_torch.oes import ParaboloidFlatLens
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import GeometricSource
    dk = dict(dtype=dtype, device='cuda')
    mat = Material.create('Be', rho=1.848, kind='lens', **dk)
    lens = ParaboloidFlatLens.create(
        focus=0.1, zmax=1.0, nCRL=(CRL_F, CRL_E0) if nCRL is None else nCRL,
        material=mat, center=(0, CRL_P, 0), t=0.05, limPhysX=(-2, 2),
        limPhysY=(-2, 2))
    delta = 1.0 - float(mat.get_refractive_index(CRL_E0).real)
    f_real = 2 * 0.1 / (lens.nCRL * delta)
    src = GeometricSource.create(
        nrays=nrays, distx='flat', dx=0.5, distz='flat', dz=0.5,
        distxprime=None, distzprime=None, dxprime=0.0, dzprime=0.0,
        distE='lines', energies=(CRL_E0,), polarization='horizontal', **dk)
    return src, lens, Screen.create(center=(0, CRL_P + f_real, 0)), f_real


def crl_numbers(glo, img):
    """(focal distance from the rays' crossings of the axis, std x, std z
    on the screen, transmission) of a beam after the stack."""
    import torch
    good = glo.state == 1
    x, y, a, b = (v.double()[good] for v in (glo.x, glo.y, glo.a, glo.b))
    far = x.abs() > 0.1
    f = float(torch.median((y - x * b / a)[far])) - CRL_P
    I = torch.where(good, glo.Jss + glo.Jpp,
                    torch.zeros_like(glo.Jss)).double()
    gi = img.state == 1
    return (f, float(img.x.double()[gi].std()),
            float(img.z.double()[gi].std()), float(I.sum()) / I.numel())


def phase_crl(timing):
    """Phase 22: the CRL stack of examples/14_lenses_crl.py."""
    import torch
    from xrt_tpu_torch import histogram as th, runner
    from xrt_tpu_torch.materials import Material
    from xrt_tpu_torch.oes import Plate
    from xrt_tpu_torch.oes import base as oebase
    f32, f64 = torch.float32, torch.float64
    n, reps = OE_NRAYS, OE_REPEATS
    src, lens, scr, f_real = crl_line(n, f32)

    def process(rng):
        return {'screen': scr.expose(lens.multiple_refract(src.shine(rng),
                                                           rng)[0])}

    def plot_fn():
        return oe_plot(dict(label='x', unit='um', limits=(-30, 30)),
                       dict(label='z', unit='um', limits=(-30, 30)),
                       dict(label='energy', unit='eV',
                            limits=(CRL_E0 - 1, CRL_E0 + 1)))
    plot, pass_ms, med, launches, peak, rng = oe_passes(process, plot_fn,
                                                        reps, 42)
    print(f'phase 22 CRL: {lens.nCRL} Be lenses, thin-lens focus '
          f'{f_real:.1f} mm; {n} rays/pass, float32, {reps} passes + '
          f'calibration: {", ".join(f"{v:.1f}" for v in pass_ms)} ms, median '
          f'{med:.1f} ms ({med / lens.nCRL:.2f} ms a lens), '
          f'{n / (med * 1e-3):.3e} rays/s; peak device memory '
          f'{peak / 2 ** 30:.2f} GiB; launches {launches}', flush=True)
    route = th.plot_route((128,) * 3)
    check(launches == {f'hist_plot:{route}': reps},
          f'CRL: not one hist_plot launch a pass: {launches}')
    # the searches and their host reads in one pass
    counts = []
    orig = oebase.find_intersection_dz

    def counted(dz_fn, *a, **k):
        evals = []

        def f(*xyz):
            evals.append(1)
            return dz_fn(*xyz)
        out = orig(f, *a, **k)
        counts.append(len(evals))
        return out
    oebase.find_intersection_dz = counted
    try:
        ms, (beam, glo, img, hists) = step_split([
            lambda: src.shine(rng),
            lambda b: lens.multiple_refract(b, rng)[0],
            lambda g: scr.expose(g),
            lambda i: runner.histogram_plot(plot, {'screen': i})])
    finally:
        oebase.find_intersection_dz = orig
    # dz evaluations: 2 bracket ends, the iterations, 2 Newton steps; a
    # host read at the start of every iteration and at the end
    reads = sum(c - 3 for c in counts)
    host_ms = [0.0]

    def one_pass():
        t0 = time.perf_counter()
        process(rng)
        torch.cuda.synchronize()
        host_ms[0] = 1e3 * (time.perf_counter() - t0)
    dev_ms = profiled_device_ms(one_pass)
    f, sx, sz, T = crl_numbers(glo, img)
    print(f'phase 22 split of a CRL pass (CUDA events): source {ms[0]:.1f} '
          f'ms, multiple_refract {ms[1]:.1f} ms ({len(counts)} searches, '
          f'{reads} host reads), expose {ms[2]:.1f} ms, histograms '
          f'{ms[3]:.2f} ms; device busy {dev_ms:.1f} ms of a {host_ms[0]:.1f}'
          f' ms pass under the profiler ({dev_ms / host_ms[0]:.1%})',
          flush=True)
    print(f'phase 22 CRL focus: crossing distance {f:.2f} mm (thin lens '
          f'{f_real:.2f}), sizes at the thin-lens focus {sx * 1e3:.3f} x '
          f'{sz * 1e3:.3f} um (std x, z), transmission {T:.5f}; plot flux '
          f'{plot.intensity:.6g}, dx {plot.dx:.4g} um, dy {plot.dy:.4g} um',
          flush=True)
    check(abs(f / f_real - 1) < 0.05 and sx < 0.02 and sz < 0.02 and
          0.3 < T < 1.0, f'CRL focus {f}, {sx}, {sz}, {T}')
    args = oe_hist_plot_check(22, 'CRL', plot, {'screen': img})
    timing['crl'] = dict(launches=launches, plot_args=args)
    del beam, glo, img, hists
    # a plate's transmission: T_fresnel^2 e^(-mu t)
    dk = dict(dtype=f32, device='cuda')
    cmat = Material.create('C', rho=3.52, kind='plate', **dk)
    plate = Plate.create(center=(0, CRL_P, 0), pitch=math.pi / 2, t=0.5,
                         material=cmat, limPhysX=(-10, 10),
                         limPhysY=(-10, 10))
    pglo = plate.double_refract(src.shine(rng))[0]
    good = pglo.state == 1
    flux = float((pglo.Jss + pglo.Jpp).double()[good].mean())
    Et = torch.full((1,), CRL_E0, **dk)
    mu = float(cmat.get_absorption_coefficient(Et)[0])
    T2 = float(cmat.get_amplitude(Et, -torch.ones_like(Et))[0].abs()[0]) ** 4
    expected = T2 * math.exp(-mu * 0.5 * 0.1)
    print(f'phase 22 C plate 0.5 mm at normal incidence: transmission '
          f'{flux:.6f}, T_fresnel^2 e^(-mu t) {expected:.6f} '
          f'({abs(flux / expected - 1):.2e}; limit 1e-3)', flush=True)
    check(abs(flux / expected - 1) < 1e-3, f'plate {flux} vs {expected}')
    # float32 against float64 on the same rays and lens count
    res = {}
    for dt in (f32, f64):
        s_, l_, sc_, fr_ = crl_line(OE_CROSS_NRAYS, dt, nCRL=lens.nCRL)
        g = l_.multiple_refract(s_.shine(torch.Generator().manual_seed(5)))[0]
        res[dt] = crl_numbers(g, sc_.expose(g))
    r32, r64 = res[f32], res[f64]
    print(f'phase 22 CRL float32 vs float64, {OE_CROSS_NRAYS} rays: focal '
          f'distance {r32[0]:.2f} / {r64[0]:.2f} mm '
          f'({abs(r32[0] / r64[0] - 1):.2e}; ROADMAP C18, 1.94e-2 in both '
          f'packages on the CPU; C12: n in float32 equals the reference '
          f'package\'s bits), sizes {r32[1] * 1e3:.3f} x {r32[2] * 1e3:.3f} '
          f'/ {r64[1] * 1e3:.3f} x {r64[2] * 1e3:.3f} um, transmission '
          f'{r32[3]:.6f} / {r64[3]:.6f}', flush=True)
    check(all(math.isfinite(v) for v in r32), 'CRL float32 not finite')


def ml_line(nrays, dtype):
    """examples/10_multilayer.py: a [W/Si]x40 (d = 45 A) multilayer on a
    FlatMirror at 10 m at the peak of its Parratt reflectivity, 8050 eV,
    a beam of dz' 4e-3 theta_B -> screen 2 m downstream."""
    import torch
    from xrt_tpu_torch.materials import Material, Multilayer
    from xrt_tpu_torch.oes import FlatMirror
    from xrt_tpu_torch.physconsts import CH
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import GeometricSource
    dk = dict(dtype=dtype, device='cuda')
    mSi = Material.create('Si', rho=2.33, **dk)
    mW = Material.create('W', rho=19.3, **dk)
    ml = Multilayer.create(mSi, 27.0, mW, 18.0, 40, mSi, **dk)
    theta0 = math.asin(CH / ML_E0 * 1e-7 / (2 * 45.0e-7))
    thetas = torch.linspace(0.9 * theta0, 1.4 * theta0, 201, dtype=dtype,
                            device='cuda')
    R = ml.get_amplitude(torch.full_like(thetas, ML_E0),
                         torch.sin(thetas))[0].abs() ** 2
    thetaB = float(thetas[int(torch.argmax(R))])
    mirror = FlatMirror.create(center=(0, ML_P, 0), pitch=thetaB,
                               material=ml, limPhysX=(-10, 10),
                               limPhysY=(-60, 60))
    src = GeometricSource.create(
        nrays=nrays, dx=0.1, dz=0.01, dxprime=1e-5, distzprime='flat',
        dzprime=4e-3 * thetaB, distE='lines', energies=(ML_E0,),
        polarization='horizontal', **dk)
    scr = Screen.create(center=(0, ML_P + ML_Q, 2 * thetaB * ML_Q))
    return src, mirror, scr, thetaB


def phase_multilayer(timing):
    """Phase 23: the multilayer mirror of examples/10_multilayer.py."""
    import torch
    from xrt_tpu_torch import histogram as th, runner
    f32, f64 = torch.float32, torch.float64
    n, reps = OE_NRAYS, OE_REPEATS
    src, mirror, scr, thetaB = ml_line(n, f32)
    ml = mirror.material

    def process(rng):
        return {'screen': scr.expose(mirror.reflect(src.shine(rng))[0])}

    def plot_fn():
        return oe_plot(dict(label='x', unit='mm', limits=(-1, 1)),
                       dict(label='z', unit='mm'),
                       dict(label="z'", unit='mrad'))
    plot, pass_ms, med, launches, peak, rng = oe_passes(process, plot_fn,
                                                        reps, 43)
    print(f'phase 23 multilayer [W/Si]x40 at theta_B {thetaB * 1e3:.4f} mrad'
          f' (the Parratt peak): {n} rays/pass, float32, {reps} passes + '
          f'calibration: {", ".join(f"{v:.1f}" for v in pass_ms)} ms, '
          f'median {med:.1f} ms, {n / (med * 1e-3):.3e} rays/s; flux '
          f'{plot.intensity:.6g}, nGood {plot.nRaysGood}; peak device '
          f'memory {peak / 2 ** 30:.2f} GiB; launches {launches}', flush=True)
    route = th.plot_route((128,) * 3)
    check(launches == {f'hist_plot:{route}': reps},
          f'multilayer: not one hist_plot launch a pass: {launches}')
    with _Timed(ml, 'get_amplitude') as tamp:
        ms, (beam, (glo, loc), img, hists) = step_split([
            lambda: src.shine(rng), lambda b: mirror.reflect(b),
            lambda g: scr.expose(g[0]),
            lambda i: runner.histogram_plot(plot, {'screen': i})])
    a_ms = tamp.ms()
    good = glo.state == 1
    E = torch.full((int(good.sum()),), ML_E0, dtype=f32, device='cuda')
    sinT = torch.sin(loc.theta[good]).abs()
    amp = lambda: ml.get_amplitude(E, sinT)     # noqa: E731
    rs = amp()[0]
    err = float((glo.Jss[good] - rs.abs() ** 2).abs().max())
    nk = profiled_kernel_count(amp)
    call_ms = cuda_ms(amp)[0]
    print(f'phase 23 split of a pass (CUDA events): source {ms[0]:.1f} ms, '
          f'reflect {ms[1]:.1f} ms (get_amplitude {a_ms:.1f} ms), expose '
          f'{ms[2]:.1f} ms, histograms {ms[3]:.2f} ms; get_amplitude on '
          f'{E.numel()} rays {call_ms:.2f} ms, {nk} kernel launches a call '
          f'(torch.profiler); traced reflectivity against the material\'s '
          f'own |rs|^2 at the rays\' angles max|d| {err:.2e} (limit 1e-3)',
          flush=True)
    check(err < 1e-3, f'multilayer traced vs material {err}')
    args = oe_hist_plot_check(23, 'multilayer', plot, {'screen': img})
    timing['multilayer'] = dict(launches=launches, plot_args=args)
    del beam, glo, loc, img, hists
    R = {}
    for dt in (f32, f64):
        _, m_, _, _ = ml_line(16, dt)
        e = torch.full((1,), ML_E0, dtype=dt, device='cuda')
        R[dt] = float(m_.material.get_amplitude(
            e, torch.full_like(e, math.sin(thetaB)))[0].abs()[0] ** 2)
    print(f'phase 23 peak reflectivity |rs|^2 at theta_B: float32 '
          f'{R[f32]:.6f}, float64 {R[f64]:.6f} '
          f'({abs(R[f32] / R[f64] - 1):.2e})', flush=True)
    check(abs(R[f32] / R[f64] - 1) < 1e-3 and R[f64] > 0.3,
          f'multilayer peak {R}')


def powder_line(nrays, dtype):
    """examples/15_xrd_powder.py: a Cu K-alpha pencil beam (0.2 x 0.2 mm)
    -> Si powder (reflexes up to 333) on a FlatMirror at 45 deg, 1 m ->
    flat detector 150 mm behind."""
    from xrt_tpu_torch.materials import Powder
    from xrt_tpu_torch.oes import FlatMirror
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import GeometricSource
    dk = dict(dtype=dtype, device='cuda')
    powder = Powder.create(hkl=(3, 3, 3), a=PW_A, name='Si', **dk)
    sample = FlatMirror.create(center=(0, PW_P, 0), pitch=math.pi / 4,
                               material=powder, limPhysX=(-2, 2),
                               limPhysY=(-2, 2))
    src = GeometricSource.create(
        nrays=nrays, dx=0.2, dz=0.2, distx='flat', distz='flat',
        distxprime=None, distzprime=None, dxprime=0.0, dzprime=0.0,
        distE='lines', energies=(PW_E0,), polarization='horizontal', **dk)
    return src, sample, Screen.create(center=(0, PW_P + PW_D, 0))


def phase_powder(timing):
    """Phase 24: the powder rings of examples/15_xrd_powder.py."""
    import torch
    from xrt_tpu_torch import histogram as th, runner
    from xrt_tpu_torch.physconsts import CH
    n, reps = OE_NRAYS, OE_REPEATS
    src, sample, det = powder_line(n, torch.float32)

    def process(rng):
        return {'screen': det.expose(sample.reflect(src.shine(rng),
                                                    rng)[0])}

    def plot_fn():
        return oe_plot(dict(label='x', unit='mm', limits=(-150, 150)),
                       dict(label='z', unit='mm', limits=(-150, 150)),
                       dict(label='theta', unit='deg', data='theta',
                            factor=180 / math.pi, limits=(0, 90)))
    plot, pass_ms, med, launches, peak, rng = oe_passes(process, plot_fn,
                                                        reps, 44)
    print(f'phase 24 powder rings (Si, reflexes up to 333, Cu K-alpha): {n} '
          f'rays/pass, float32, {reps} passes + calibration: '
          f'{", ".join(f"{v:.1f}" for v in pass_ms)} ms, median {med:.1f} ms,'
          f' {n / (med * 1e-3):.3e} rays/s; detector flux '
          f'{plot.intensity:.6g}, nGood {plot.nRaysGood}; peak device memory '
          f'{peak / 2 ** 30:.2f} GiB; launches {launches}', flush=True)
    route = th.plot_route((128,) * 3)
    check(launches == {f'hist_plot:{route}': reps},
          f'powder: not one hist_plot launch a pass: {launches}')
    with _Timed(sample.material, 'reflect_multi_hkl') as tr:
        ms, (beam, glo, img, hists) = step_split([
            lambda: src.shine(rng), lambda b: sample.reflect(b, rng)[0],
            lambda g: det.expose(g),
            lambda i: runner.histogram_plot(plot, {'screen': i})])
    r_ms = tr.ms()
    print(f'phase 24 split of a pass (CUDA events): source {ms[0]:.1f} ms, '
          f'reflect {ms[1]:.1f} ms (reflect_multi_hkl over '
          f'{sample.material.reflex_tables()[0].shape[0]} reflexes '
          f'{r_ms:.1f} ms), expose {ms[2]:.1f} ms, histograms {ms[3]:.2f} ms',
          flush=True)
    # the ring radii against Bragg's law
    ok = (img.state == 1) & (glo.b > 0)
    r = torch.sqrt(img.x.double() ** 2 + img.z.double() ** 2)[ok]
    w = (img.Jss + img.Jpp).double()[ok]
    worst = 0.0
    for hkl in ((1, 1, 1), (2, 2, 0), (3, 1, 1)):
        d = PW_A / math.sqrt(sum(i * i for i in hkl))
        r0 = PW_D * math.tan(2 * math.asin(CH / PW_E0 / (2 * d)))
        near = (r > 0.97 * r0) & (r < 1.03 * r0)
        rm = float((w[near] * r[near]).sum() / w[near].sum())
        worst = max(worst, abs(rm / r0 - 1))
        print(f'phase 24 ring {hkl}: weighted radius {rm:.3f} mm, Bragg '
              f'{r0:.3f} mm ({abs(rm / r0 - 1):.2e}; limit 1e-2), '
              f'{int(near.sum())} rays', flush=True)
        check(int(near.sum()) > 0 and abs(rm / r0 - 1) < 1e-2,
              f'powder ring {hkl}: {rm} vs {r0}')
    args = oe_hist_plot_check(24, 'powder', plot, {'screen': img})
    timing['powder'] = dict(launches=launches, plot_args=args,
                            multi_hkl_ms=r_ms)


# ---------------------------------------------------------------------------
# figure errors, capillaries and conics, STL meshes and TXM volumes
# ---------------------------------------------------------------------------

#: examples/11_warping.py: energy, arms, grazing angle of the Rh toroid
FE_E0, FE_P, FE_Q, FE_PITCH = 9000.0, 10000.0, 2000.0, 4e-3
#: tests/test_figure_error.py:63's flat mirror: waviness amplitude (nm) and
#: period (mm), the fan's divergence
FE_FLAT_AMP, FE_FLAT_PERIOD, FE_FLAT_DIV = 50.0, 20.0, 2e-5
#: float32 against float64 on the same rays: flux per ray (the mirror's
#: float32 Fresnel amplitude near the critical angle, ROADMAP C3) and the
#: spread the figure error adds
FE_F32_LIMITS = (3e-2, 1e-2)


def fe_maps(dtype, device='cuda'):
    """The three figure errors of examples/11_warping.py's toroid (20 x 600
    mm, 1 mm grid): a 30 nm, 80 mm waviness, a 20 nm rms random roughness
    of 15 mm correlation length, and a 30 nm Gaussian bump (10 x 60 mm)."""
    from xrt_tpu_torch import figure_error as fe
    lims = dict(limPhysX=(-20, 20), limPhysY=(-300, 300), gridStep=1.0,
                dtype=dtype, device=device)
    return {'waviness': fe.waviness(amplitude=30.0, period=80.0, **lims),
            'roughness': fe.random_roughness(rms=20.0, corrLength=15.0,
                                             seed=3, **lims),
            'bump': fe.gaussian_bump(height=30.0, sigmaX=10.0, sigmaY=60.0,
                                     **lims)}


def fe_line(nrays, dtype, figure_error=None):
    """examples/11_warping.py: GeometricSource (9 keV, 0.1 x 0.05 mm, 3e-5
    rad) -> Rh toroid at 10 m focusing at 2 m, 4 mrad, carrying
    *figure_error* -> screen at the focus."""
    from xrt_tpu_torch.materials import Material
    from xrt_tpu_torch.oes import ToroidMirror
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import GeometricSource
    dk = dict(dtype=dtype, device='cuda')
    src = GeometricSource.create(
        nrays=nrays, dx=0.1, dz=0.05, dxprime=3e-5, dzprime=3e-5,
        distE='lines', energies=(FE_E0,), polarization='horizontal', **dk)
    P, Q, th = FE_P, FE_Q, FE_PITCH
    mirror = ToroidMirror.create(
        center=(0, P, 0), pitch=th, R=2 * P * Q / (P + Q) / math.sin(th),
        r=2 * P * Q / (P + Q) * math.sin(th),
        material=Material.create('Rh', rho=12.41, **dk),
        limPhysX=(-20, 20), limPhysY=(-300, 300), figure_error=figure_error)
    return src, mirror, Screen.create(center=(0, P + Q, 2 * th * Q))


def fe_spread(mirror, fe_, beam):
    """Reflect *beam* off *mirror* without and with the figure error
    *fe_*: (the std of the meridional angle the error adds to each ray,
    twice the std of the normal's turn that the error's slopes give at
    the rays' points on the mirror, the flux per ray with the error, the
    rays good in both)."""
    import torch
    g0, l0 = mirror.replace(figure_error=None).reflect(beam)
    g1, _ = mirror.replace(figure_error=fe_).reflect(beam)
    ok = (g0.state == 1) & (g1.state == 1)
    d = (torch.atan2(g1.c, g1.b) - torch.atan2(g0.c, g0.b)).double()[ok]
    turn = fe_.local_n_distorted(l0.x, l0.y)[0].double()[ok]
    flux = torch.where(g1.state == 1, g1.Jss + g1.Jpp,
                       torch.zeros_like(g1.Jss)).double().mean()
    return float(d.std()), 2 * float(turn.std()), float(flux), int(ok.sum())


def phase_figure_errors(timing):
    """Phase 25: the figure errors of examples/11_warping.py on the ray
    trace."""
    import torch
    from xrt_tpu_torch import figure_error as fe, histogram as th, runner
    from xrt_tpu_torch.oes import FlatMirror
    from xrt_tpu_torch.sources import GeometricSource
    f32, f64 = torch.float32, torch.float64
    n, reps = OE_NRAYS, OE_REPEATS
    route = th.plot_route((128,) * 3)
    for seed, (name, fe_) in enumerate(fe_maps(f32).items()):
        src, mirror, scr = fe_line(n, f32, fe_)

        def process(rng):
            return {'screen': scr.expose(mirror.reflect(src.shine(rng))[0])}

        def plot_fn():
            return oe_plot(dict(label='x', unit='mm', limits=(-1, 1)),
                           dict(label='z', unit='mm', limits=(-1, 1)),
                           dict(label="z'", unit='mrad', data='zprime',
                                factor=1e3, limits=(7.7, 8.3)))
        plot, pass_ms, med, launches, peak, rng = oe_passes(
            process, plot_fn, reps, 50 + seed)
        check(launches == {f'hist_plot:{route}': reps},
              f'figure error {name}: not one hist_plot launch a pass: '
              f'{launches}')
        with _Timed(fe_, 'local_z_distorted') as tz, \
                _Timed(fe_, 'local_n_distorted') as tn:
            ms, (beam, (glo, loc), img, hists) = step_split([
                lambda: src.shine(rng), lambda b: mirror.reflect(b),
                lambda g: scr.expose(g[0]),
                lambda i: runner.histogram_plot(plot, {'screen': i})])
        print(f'phase 25 figure error {name} on the Rh toroid (rms '
              f'{float(fe_.get_rms()):.2f} nm): {n} rays/pass, float32, '
              f'{reps} passes + calibration: '
              f'{", ".join(f"{v:.1f}" for v in pass_ms)} ms, median '
              f'{med:.1f} ms, {n / (med * 1e-3):.3e} rays/s; dz '
              f'{plot.dy:.4g} mm, flux {plot.intensity:.6g}, nGood '
              f'{plot.nRaysGood}; split (CUDA events): source {ms[0]:.1f} '
              f'ms, reflect {ms[1]:.1f} ms (the map\'s heights '
              f'{tz.ms():.2f} ms, normals {tn.ms():.2f} ms), expose '
              f'{ms[2]:.1f} ms, histograms {ms[3]:.2f} ms; peak device '
              f'memory {peak / 2 ** 30:.2f} GiB; launches {launches}',
              flush=True)
        spread, expect, _, good = fe_spread(mirror, fe_, beam)
        print(f'phase 25 {name}: the meridional angle it adds, std '
              f'{spread:.4e} rad over {good} rays; 2 x the std of the '
              f'normal\'s turn at their points {expect:.4e} rad '
              f'({abs(spread / expect - 1):.2e}; limit 0.15)', flush=True)
        check(abs(spread / expect - 1) < 0.15,
              f'figure error {name}: spread {spread} vs {expect}')
        args = oe_hist_plot_check(25, f'figure-error {name}', plot,
                                  {'screen': img})
        timing[f'fe:{name}'] = dict(launches=launches, plot_args=args)
        del beam, glo, loc, img, hists
    # tests/test_figure_error.py:63 on the card: a flat mirror with a
    # waviness broadens a fan by twice its rms slope
    dk = dict(dtype=f32, device='cuda')
    w = fe.waviness(amplitude=FE_FLAT_AMP, period=FE_FLAT_PERIOD,
                    limPhysX=(-10, 10), limPhysY=(-200, 200), gridStep=0.2,
                    **dk)
    flat = FlatMirror.create(center=(0, FE_P, 0), pitch=FE_PITCH,
                             limPhysX=(-10, 10), limPhysY=(-200, 200))
    fan = GeometricSource.create(
        nrays=n, dx=0.0, dz=0.0, distx=None, distz=None, distxprime=None,
        dxprime=0.0, dzprime=FE_FLAT_DIV, distE='lines', energies=(FE_E0,),
        polarization='horizontal', **dk)
    spread, _, _, good = fe_spread(flat, w, fan.shine(
        torch.Generator('cuda').manual_seed(57)))
    slope = 2 * math.pi * FE_FLAT_AMP * 1e-6 / FE_FLAT_PERIOD / math.sqrt(2)
    print(f'phase 25 flat mirror with a {FE_FLAT_AMP:.0f} nm, '
          f'{FE_FLAT_PERIOD:.0f} mm waviness, {good} rays: extra angular '
          f'spread {spread:.4e} rad, 2 x the rms slope {2 * slope:.4e} '
          f'({abs(spread / (2 * slope) - 1):.2e}; limit 0.15)', flush=True)
    check(abs(spread / (2 * slope) - 1) < 0.15,
          f'flat waviness spread {spread} vs {2 * slope}')
    # float32 against float64 on the same rays (a host generator)
    res = {}
    for dt in (f32, f64):
        fe_ = fe_maps(dt)['waviness']
        src, mirror, _ = fe_line(OE_CROSS_NRAYS, dt)
        res[dt] = fe_spread(mirror, fe_, src.shine(
            torch.Generator().manual_seed(58)))
    (s32, _, f32_, _), (s64, _, f64_, _) = res[f32], res[f64]
    ef, es = abs(f32_ / f64_ - 1), abs(s32 / s64 - 1)
    print(f'phase 25 waviness float32 vs float64, {OE_CROSS_NRAYS} rays: '
          f'flux per ray {f32_:.6f} / {f64_:.6f} ({ef:.2e}; limit '
          f'{FE_F32_LIMITS[0]:.0e}), added spread {s32:.5e} / {s64:.5e} '
          f'({es:.2e}; limit {FE_F32_LIMITS[1]:.0e})', flush=True)
    check(ef < FE_F32_LIMITS[0] and es < FE_F32_LIMITS[1],
          f'figure error float32 vs float64: {ef:.3e}, {es:.3e}')


#: examples/16_parametric_optimization.py part 2: energy (eV), source to
#: M1, M1 to M2 and M2 to the focus (mm), the 1-degree grazing angle
FW_E0, FW_P1, FW_D12, FW_Q = 280.0, 24000.0, 2000.0, 4000.0
FW_PITCH = math.radians(1.0)
#: the main run's samples on the slit, on each mirror, and the screen's
#: side; the cross-checks' (the example's own: 20000 slit samples, 48 x 64
#: mirror samples, a 129-point screen, here 129 x 129)
FW_MAIN, FW_CROSS = (200_000, 200_000, 129), (20_000, 48 * 64, 129)
#: the working point: the waviness amplitude (nm; the example's polishing
#: error of 12 nm, on M2's 1 nm mode) and M2's pitch offset.  At 1 nm the
#: focal flux is flat to first order in the amplitude (its relative slope
#: 2.7e-5 a nm), and the float32 gradient is a difference of sums that
#: cancel
FW_POINT = (12.0, 0.0)
FW_NAMES = ('amplitude', 'M2 pitch')
#: four-point central differences (ROADMAP C6: float64 steps of 1e-6 to
#: 1e-5 mm in height, here 1 nm of amplitude; 3e-8 rad in pitch as phase
#: 10 takes)
FW_STEPS = (1.0, 3e-8)


def fw_line(dtype, nslit, nmirror, nscr, seed=0):
    """examples/16_parametric_optimization.py part 2's branch: a Gaussian
    source field (w0 0.05 mm, 280 eV) on a 0.6 mm slit -> Au toroid M1
    (24 m, imaging onto the focus, 1 deg) -> flat M2 2 m on, deflecting
    down, carrying a 1 nm, 4 mm waviness -> an nscr x nscr screen at the
    focus.  The waves' samples are drawn on the host (the same in either
    dtype).  Returns a dict: the elements, the prepared waves, the
    retargeting constants and ``loss(amp, dp2)``, the Gaussian-weighted
    focal flux (a window 1.5 focal sizes off the centre, so that neither
    gradient vanishes by symmetry) as a function of the waviness amplitude
    (nm) and M2's pitch offset."""
    import numpy as np
    import torch
    from xrt_tpu_torch import figure_error as fe, waves as W
    from xrt_tpu_torch.apertures import RectangularAperture
    from xrt_tpu_torch.materials import Material
    from xrt_tpu_torch.oes import FlatMirror, ToroidMirror
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import GaussianBeam
    dk = dict(dtype=dtype, device='cuda')
    mat = Material.create('Au', rho=19.3, kind='mirror', **dk)
    slit = RectangularAperture.create(center=(0, 0, 0),
                                      opening=(-0.3, 0.3, -0.3, 0.3))
    P, D, Q, th = FW_P1, FW_D12, FW_Q, FW_PITCH
    limY2 = (-14.0, 14.0)
    fe_mode = fe.waviness(amplitude=1.0, period=4.0, limPhysX=(-1, 1),
                          limPhysY=limY2, gridStep=0.25, **dk)
    m1 = ToroidMirror.create(center=(0, P, 0), pitch=th,
                             R=2 * P * Q / (P + Q) / math.sin(th),
                             r=2 * P * Q / (P + Q) * math.sin(th),
                             material=mat, limPhysX=(-0.8, 0.8),
                             limPhysY=(-24.0, 24.0))
    zM2 = D * math.sin(2 * th)
    m2 = FlatMirror.create(center=(0, P + D * math.cos(2 * th), zM2),
                           pitch=-th, positionRoll=math.pi, material=mat,
                           limPhysX=(-0.5, 0.5), limPhysY=limY2,
                           figure_error=fe_mode)
    scr = Screen.create(center=(0, P + D * math.cos(2 * th) + Q - D, zM2))
    gb = GaussianBeam.create(w0=0.05, distE='lines', energies=(FW_E0,),
                             polarization='horizontal')
    gen = lambda k: torch.Generator().manual_seed(seed + k)  # noqa: E731
    wSlit = W.prepare_wave_on_aperture(slit, gb, nslit, generator=gen(0),
                                       **dk)
    srcBeam = gb.shine(None, wSlit, toGlobal=False)
    wM1 = W.prepare_wave_on_oe(m1, slit, nmirror, generator=gen(2), **dk)
    wM2 = W.prepare_wave_on_oe(m2, m1, nmirror, generator=gen(3), **dk)
    w_foc = 12398.4 / FW_E0 * 1e-7 * Q / 0.66
    zs = np.linspace(-18 * w_foc, 18 * w_foc, nscr)
    wScr = W.prepare_wave_on_screen(scr, m2, zs, zs, **dk)

    def h64(t):
        return t.detach().double().cpu().numpy()

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), **dk)
    J22 = dev(W._placement_jacobian(m2, m1, h64(wM2.x), h64(wM2.y),
                                    h64(wM2.z)))
    J32 = dev(W._placement_jacobian(scr, m2, h64(wScr.x), h64(wScr.y),
                                    h64(wScr.z), vary='from'))
    R2 = [float(v) for v in W.wave_frame_rotation(m2, m1)[:, 2]]
    unit_z = fe_mode.local_z_distorted(wM2.x, wM2.y)
    wgt = torch.exp(-(wScr.x ** 2 + (wScr.z - 1.5 * w_foc) ** 2) /
                    (2.5 * w_foc) ** 2)

    def loss(amp, dp2):
        fe_ = fe_mode.replace(zmap=amp * fe_mode.zmap,
                              dzdx=amp * fe_mode.dzdx,
                              dzdy=amp * fe_mode.dzdy)
        m2_ = m2.replace(pitch=m2.pitch + dp2, figure_error=fe_)
        dz = (amp - 1.0) * unit_z
        w2 = wM2.replace(xDiffr=wM2.xDiffr + J22[0] * dp2 + R2[0] * dz,
                         yDiffr=wM2.yDiffr + J22[1] * dp2 + R2[1] * dz,
                         zDiffr=wM2.zDiffr + J22[2] * dp2 + R2[2] * dz,
                         z=wM2.z + dz)
        ws = wScr.replace(xDiffr=wScr.xDiffr + J32[0] * dp2,
                          yDiffr=wScr.yDiffr + J32[1] * dp2,
                          zDiffr=wScr.zDiffr + J32[2] * dp2)
        _, l1 = W.reflect_wave(m1, W.diffract(srcBeam, wM1,
                                              monochromatic=True))
        _, l2 = W.reflect_wave(m2_, W.diffract(l1, w2, monochromatic=True))
        out = W.diffract(l2, ws, monochromatic=True)
        return ((out.Jss + out.Jpp) * wgt).double().sum() * 1e-6

    return dict(loss=loss, m1=m1, m2=m2, scr=scr, src=srcBeam, wM1=wM1,
                wM2=wM2, wScr=wScr, w_foc=w_foc)


def fw_leaves(dtype, point=FW_POINT):
    import torch
    return [torch.tensor(v, dtype=dtype, device='cuda', requires_grad=True)
            for v in point]


@contextlib.contextmanager
def b1_b3_by_shape():
    """Count the launches of B1 and of its adjoint B3 inside the block by
    (destinations, sources)."""
    from xrt_tpu_torch.ops import kirchhoff as tk
    bwd, rows_fwd = tk._launch_recentred_bwd, tk._launch_rows
    counts = dict(fwd=collections.Counter(), bwd=collections.Counter())

    def rows_rec(scheme, v, D, rows, P, ns):
        if scheme == 'recentred':
            counts['fwd'][D.shape[1]] += 1
        return rows_fwd(scheme, v, D, rows, P, ns)

    def bwd_rec(D, S, P, G, v):
        counts['bwd'][D.shape[1]] += 1
        return bwd(D, S, P, G, v)
    tk._launch_recentred_bwd, tk._launch_rows = bwd_rec, rows_rec
    try:
        yield counts
    finally:
        tk._launch_recentred_bwd, tk._launch_rows = bwd, rows_fwd


def phase_fe_wave(timing):
    """Phase 26: a figure error on the wave chain and its gradient
    (examples/16_parametric_optimization.py part 2's geometry)."""
    import torch
    from xrt_tpu_torch import waves as W
    from xrt_tpu_torch.ops import kirchhoff as tk
    f32, f64 = torch.float32, torch.float64
    t0 = time.perf_counter()
    line = fw_line(f32, *FW_MAIN, seed=60)
    t_build = time.perf_counter() - t0
    loss = line['loss']

    def step():
        leaves = fw_leaves(f32)
        val = loss(*leaves)
        grads = torch.autograd.grad(val, leaves)
        torch.cuda.synchronize()
        return val, grads

    def forward():
        with torch.no_grad():
            val = loss(*fw_leaves(f32))
        torch.cuda.synchronize()
        return val
    step()      # warm-up
    torch.cuda.reset_peak_memory_stats()
    tk.LAUNCHES.clear()
    with b1_b3_by_shape() as shapes:
        t0 = time.perf_counter()
        val, grads = step()
        times = [time.perf_counter() - t0]
    launches = dict(tk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for _ in range(2):
        t0 = time.perf_counter()
        val, grads = step()
        times.append(time.perf_counter() - t0)
    fwd = []
    for _ in range(3):
        t0 = time.perf_counter()
        forward()
        fwd.append(time.perf_counter() - t0)
    med, medf = statistics.median(times), statistics.median(fwd)
    vals = [float(g) for g in grads]
    ns, nm, nscr = FW_MAIN
    pairs = ns * nm + nm * nm + nm * nscr * nscr
    print(f'phase 26 figure error on the wave chain (slit -> Au toroid M1 '
          f'-> flat M2 with a 1 nm, 4 mm waviness -> {nscr}x{nscr} screen, '
          f'280 eV): {ns} slit samples, {nm} on each mirror, float32; '
          f'build {t_build:.2f} s; loss {float(val.detach()):.6e}; '
          f'gradients {dict(zip(FW_NAMES, vals))}; forward median of 3 '
          f'{medf * 1e3:.1f} ms ({", ".join(f"{t * 1e3:.1f}" for t in fwd)}'
          f'), forward + backward {med * 1e3:.1f} ms '
          f'({", ".join(f"{t * 1e3:.1f}" for t in times)}), ratio '
          f'{med / medf:.2f}; {pairs / medf:.3e} pairs/s forward; peak '
          f'device memory {peak / 2 ** 30:.2f} GiB; launches of one step '
          f'{launches}; B1 by destinations {dict(shapes["fwd"])}, B3 '
          f'{dict(shapes["bwd"])}', flush=True)
    check(all(math.isfinite(v) and v != 0.0 for v in vals) and
          math.isfinite(float(val.detach())),
          f'figure-error wave chain: loss {float(val.detach())}, gradients '
          f'{vals}')
    check(launches == {'kirchhoff_recentred:mono': 3,
                       'kirchhoff_recentred_bwd:mono': 2, 'prep:mono': 1},
          f'figure-error wave chain: launches {launches}')
    tk.LAUNCHES.clear()
    t0 = time.perf_counter()
    with plain_recentred_adjoint() as plain_ms:
        ref = [float(g) for g in step()[1]]
    t_ref = time.perf_counter() - t0
    ref_launches = dict(tk.LAUNCHES)
    errs = [abs(a / b - 1) for a, b in zip(vals, ref)]
    print(f'phase 26 the same step with the plain blocked backward in place '
          f'of the adjoint kernels ({t_ref:.1f} s, launches {ref_launches}; '
          f'plain backward by destinations, ms: '
          f'{ {n: round(t, 1) for n, t in plain_ms.items()} }): gradients '
          f'{dict(zip(FW_NAMES, ref))}; kernels vs plain '
          f'{", ".join(f"{e:.2e}" for e in errs)} (limit '
          f'{GRAD_PLAIN_LIMIT:.0e})', flush=True)
    check(ref_launches == {'kirchhoff_recentred:mono': 3, 'prep:mono': 1},
          f'plain-backward step: launches {ref_launches}')
    check(max(errs) < GRAD_PLAIN_LIMIT,
          f'figure-error gradient, kernels vs plain backward: {errs}')
    # the hops' inputs for the kernels line: M1 -> M2 and M2 -> screen
    with torch.no_grad():
        _, l1 = W.reflect_wave(line['m1'], W.diffract(
            line['src'], line['wM1'], monochromatic=True))
        b2 = W.diffract(l1, line['wM2'], monochromatic=True)
        _, l2 = W.reflect_wave(line['m2'], b2)
    timing['fe_wave'] = dict(stages=[(l1, line['wM2']),
                                     (l2, line['wScr'])],
                             fwd=dict(shapes['fwd']),
                             bwd=dict(shapes['bwd']), plain_ms=plain_ms)
    del line, loss, b2
    # the example's sizes: float32 (kernels) against float64 (plain), and
    # float64 against four-point differences
    res = {}
    for dt in (f32, f64):
        ln = fw_line(dt, *FW_CROSS, seed=61)
        leaves = fw_leaves(dt)
        val = ln['loss'](*leaves)
        res[dt] = (float(val.detach()), [float(g) for g in
                                         torch.autograd.grad(val, leaves)])
    fds = []
    for i, h in enumerate(FW_STEPS):
        f = {}
        for m in (-2, -1, 1, 2):
            pt = list(FW_POINT)
            pt[i] += m * h
            with torch.no_grad():
                f[m] = float(ln['loss'](*[torch.tensor(
                    v, dtype=f64, device='cuda') for v in pt]))
        fds.append((f[-2] - 8 * f[-1] + 8 * f[1] - f[2]) / (12 * h))
    (l32, g32), (l64, g64) = res[f32], res[f64]
    print(f'phase 26 cross-check at the example\'s sizes ({FW_CROSS[0]} '
          f'slit samples, {FW_CROSS[1]} a mirror, {FW_CROSS[2]}^2 screen): '
          f'loss float32 {l32:.6e} float64 {l64:.6e}', flush=True)
    for name, a, b, fd in zip(FW_NAMES, g32, g64, fds):
        e32, efd = abs(a / b - 1), abs(b / fd - 1)
        print(f'phase 26 d/d({name}): float32 kernels {a:.6e}, float64 '
              f'plain {b:.6e}, finite difference {fd:.6e}; float32 vs '
              f'float64 {e32:.2e} (limit 3e-2), float64 vs FD {efd:.2e} '
              f'(limit 1e-3)', flush=True)
        check(e32 < 3e-2, f'figure-error gradient {name}: float32 vs '
              f'float64 {e32:.3e}')
        check(efd < 1e-3, f'figure-error gradient {name}: float64 vs FD '
              f'{efd:.3e}')


def fe_wave_rows(timing):
    """B1 and B3 at phase 26's two differentiated hops (M1 -> M2, M2 ->
    the screen), with that phase's launches."""
    import torch
    from xrt_tpu_torch import waves as W
    from xrt_tpu_torch.ops import kirchhoff as tk
    fw = timing['fe_wave']
    rows = []
    for stage in fw['stages']:
        name, variant = 'kirchhoff_recentred', 'mono'
        key = f'{name}:{variant}'
        ms, plain_ms, ab, rel, Nd, Ns, _ = time_kernel(name, variant, stage)
        bms, by = bound_ms(key, Nd, Ns)
        launches = int(fw['fwd'].get(Nd, 0))
        print(f'phase 5 {key}:figure-error {Nd} x {Ns} pairs: kernel '
              f'{ms:.2f} ms, plain {plain_ms:.1f} ms, bound {bms:.2f} ms '
              f'({by}), {bms / ms:.1%} of bound, max rel {rel:.2e}, '
              f'launches of a step {launches}', flush=True)
        check(rel < 2e-5, f'{key} at the figure-error hop {Nd} x {Ns}: '
              f'{rel:.3e}')
        check(launches > 0, f'{key} {Nd} x {Ns} was not launched on its path')
        rows.append(dict(name=f'{key}:figure-error-{Nd}x{Ns}', route='cuda',
                         source=SOURCES[name], replaces=REPLACES[name],
                         launches=launches, max_abs_err=ab, max_rel_err=rel,
                         ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=None))
        name = 'kirchhoff_recentred_bwd'
        key = f'{name}:{variant}'
        args = W.kirchhoff_kernel_args(*stage)
        scheme, v, D, S, P = tk._kernel_inputs(*args, variant)
        S = tk._pad_sources(S)
        G = torch.randn((10, Nd), device='cuda',
                        generator=torch.Generator('cuda').manual_seed(11))
        got = launch_adjoint(scheme, v, D, S, P, G)
        torch.cuda.synchronize()
        ms = statistics.median(cuda_ms(lambda: launch_adjoint(
            scheme, v, D, S, P, G))[0] for _ in range(3))
        relD, relS, relP, ab = sliced_adjoint_errors(scheme, v, D, S, P, G,
                                                     got, Ns)
        bms, by = bound_ms(key, Nd, Ns)
        launches = int(fw['bwd'].get(Nd, 0))
        plain_ms = fw['plain_ms'][Nd]
        print(f'phase 5 {key}:figure-error {Nd} x {Ns} pairs: kernel '
              f'{ms:.2f} ms, plain blocked backward in phase 26\'s step '
              f'{plain_ms:.1f} ms, bound {bms:.2f} ms ({by}), '
              f'{bms / ms:.1%} of bound; on slices max row rel: dst '
              f'{relD:.2e}, src {relS:.2e}, scalars {relP:.2e} (limit '
              f'{ADJ_LIMIT:.0e}); launches of a step {launches}', flush=True)
        check(max(relD, relS, relP) < ADJ_LIMIT,
              f'{key} at the figure-error hop {Nd} x {Ns}: {relD:.3e} / '
              f'{relS:.3e} / {relP:.3e}')
        check(launches > 0, f'{key} {Nd} x {Ns} was not launched on its path')
        rows.append(dict(name=f'{key}:figure-error-{Nd}x{Ns}', route='cuda',
                         source=SOURCES[name], replaces=REPLACES[name],
                         launches=launches, max_abs_err=ab,
                         max_rel_err=max(relD, relS, relP),
                         err_shape=f'{Nd}x{Ns}, on slices', ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=None))
    return rows


#: examples/09_capillary.py's capillary (ellipse semi-axes and working
#: distance, mm); its source here 10 mm before the entrance, an annulus
#: of 0.05-0.25 mm with 3 mrad of divergence, so that rays bounce several
#: times; a bounce count's share of the rays, float32 against float64
CAP_A, CAP_B, CAP_WD, CAP_MAXR = 5000.0, 2.0, 50.0, 8
CAP_F32_LIMIT = 5e-3


def cap_line(nrays, dtype):
    """examples/09_capillary.py: an EllipsoidCapillaryMirror (Si, 200 mm
    long, centred at 1 m) fed by an annulus source, a screen at the
    working distance past its exit."""
    from xrt_tpu_torch.materials import Material
    from xrt_tpu_torch.oes import EllipsoidCapillaryMirror
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import GeometricSource
    dk = dict(dtype=dtype, device='cuda')
    cap = EllipsoidCapillaryMirror.create(
        ellipseA=CAP_A, ellipseB=CAP_B, workingDistance=CAP_WD,
        center=(0, 1000.0, 0),
        material=Material.create('Si', rho=2.33, kind='mirror', **dk),
        limPhysX=(-5, 5), limPhysY=(-100, 100))
    src = GeometricSource.create(
        nrays=nrays, center=(0, 890.0, 0), distx='annulus',
        dx=(0.05, 0.25), dz=0.0, distz=None, dxprime=3e-3, dzprime=3e-3,
        distE='lines', energies=(FE_E0,), polarization='horizontal', **dk)
    return src, cap, Screen.create(center=(0, 1100.0 + CAP_WD, 0))


def bounce_shares(glo):
    import torch
    good = glo.state == 1
    counts = torch.bincount(glo.nRefl[good].long(),
                            minlength=CAP_MAXR + 1).double()
    return (counts / glo.state.numel()).tolist()


#: the parabolic mirror's collimated angle std: tests/test_parametric.py's
#: 1e-7 rad in float64; in float32 s carries an ulp of y0 = -1e4 mm (ROADMAP
#: C7), 4.35e-7 rad on an H100 80GB HBM3 at 700 W, held to 1e-6
COLLIMATION_STD = {'float32': 1e-6, 'float64': 1e-7}


def conic_checks():
    """One reflect pass of 1e6 rays off the parabolic and hyperbolic
    mirrors and a DualVFM stripe, float32 and float64, held to the reference
    package's tests' foci."""
    import torch
    from xrt_tpu_torch.oes import (DualVFM, HyperbolicMirrorParam,
                                   ParabolicalMirrorParam)
    from xrt_tpu_torch.sources import GeometricSource
    P, th = 10000.0, 4e-3
    for dt in (torch.float32, torch.float64):
        dk = dict(dtype=dt, device='cuda')

        def fan(dzprime, dx=0.0, dxprime=0.0):
            return GeometricSource.create(
                nrays=OE_NRAYS, dx=dx, dz=0.0, distx=None if not dx else
                'normal', distz=None, distxprime=None if not dxprime else
                'normal', dxprime=dxprime, dzprime=dzprime, distE='lines',
                energies=(FE_E0,), polarization='horizontal', **dk).shine(
                torch.Generator('cuda').manual_seed(70))
        tag = 'float32' if dt == torch.float32 else 'float64'
        par = ParabolicalMirrorParam.create(
            p=P, pitch=th, center=(0, P, 0), limPhysX=(-20, 20),
            limPhysY=(-400, 400))
        ms, (glo,) = step_split([lambda: par.reflect(fan(5e-5))[0]])
        good = glo.state == 1
        ang = torch.atan2(glo.c, glo.b).double()[good]
        frac = float(good.double().mean())
        print(f'phase 27 parabolic mirror (p 10 m, 4 mrad), {tag}: shine + '
              f'reflect {ms[0]:.1f} ms; good {frac:.4f}; collimated angle '
              f'std {float(ang.std()):.3e} rad (limit '
              f'{COLLIMATION_STD[tag]:.0e}), mean '
              f'{float(ang.mean()):.7e} (2 pitch {2 * th:.1e}, '
              f'{abs(float(ang.mean()) / (2 * th) - 1):.2e}; limit 1e-3)',
              flush=True)
        check(frac > 0.9 and float(ang.std()) < COLLIMATION_STD[tag] and
              abs(float(ang.mean()) / (2 * th) - 1) < 1e-3,
              f'parabolic collimation {tag}: {frac}, {float(ang.std())}')
        q = 3000.0
        hyp = HyperbolicMirrorParam.create(
            p=P, q=q, pitch=th, center=(0, P, 0), limPhysX=(-20, 20),
            limPhysY=(-400, 400))
        ms, (glo,) = step_split([lambda: hyp.reflect(fan(2e-5))[0]])
        good = glo.state == 1
        y0, z0, b, c = (v.double()[good] for v in (glo.y, glo.z, glo.b,
                                                    glo.c))
        slope = c / b
        A = torch.stack([slope, torch.ones_like(slope)], 1)
        sol = torch.linalg.lstsq(A, (slope * y0 - z0)[:, None]).solution
        yw, yexp = float(sol[0, 0]), P - q * math.cos(2 * th)
        frac = float(good.double().mean())
        print(f'phase 27 hyperbolic mirror (p 10 m, q 3 m), {tag}: shine + '
              f'reflect {ms[0]:.1f} ms; good {frac:.4f}; virtual focus at y '
              f'{yw:.2f} mm ({yexp:.2f}: {abs(yw / yexp - 1):.2e}; limit '
              f'2e-2)', flush=True)
        check(frac > 0.8 and abs(yw / yexp - 1) < 2e-2,
              f'hyperbolic focus {tag}: {frac}, {yw}')
        vfm = DualVFM.create(center=(0, P, 0), pitch=th, R=5e6, r1=70.0,
                             xCylinder1=23.5, hCylinder1=0.1, r2=36.0,
                             xCylinder2=-25.0, hCylinder2=0.1,
                             limPhysX=(-50, 50), limPhysY=(-100, 100))
        x = torch.tensor([23.5, 24.5, -25.0, -24.0], **dk)
        z = vfm.local_z(x, torch.zeros_like(x)).double()
        sag = (float(z[1] - z[0]) * 2 * 70.0, float(z[3] - z[2]) * 2 * 36.0)
        stripe, dxs = vfm.select_surface(1)
        beam = fan(1e-5, dx=0.2, dxprime=2e-5)
        beam = beam.replace(x=beam.x - dxs)
        ms, (glo,) = step_split([lambda: stripe.reflect(beam)[0]])
        good = glo.state == 1
        qs = 1.0 / (2 * math.sin(th) / 36.0 - 1.0 / P)
        t = (qs - (glo.y - P)) / glo.b
        xf = (glo.x + glo.a * t).double()[good]
        x0 = (glo.x + glo.a * (2 * qs - (glo.y - P)) / glo.b).double()[good]
        print(f'phase 27 DualVFM, {tag}: sags of the two cylinders 1 mm off '
              f'their axes x 2r {sag[0]:.4f}, {sag[1]:.4f} (1; limit 1e-2); '
              f'stripe 2 (r 36 mm) reflect {ms[0]:.1f} ms, sagittal size at '
              f'its focus {qs:.0f} mm behind {float(xf.std()):.4f} mm, at '
              f'twice that {float(x0.std()):.4f} mm', flush=True)
        check(all(abs(s - 1) < 1e-2 for s in sag) and
              float(xf.std()) < 0.5 * float(x0.std()),
              f'DualVFM {tag}: {sag}, {float(xf.std())}, {float(x0.std())}')


def phase_capillary(timing):
    """Phase 27: the capillary of examples/09_capillary.py with multiple
    reflections, and the parabolic, hyperbolic and DualVFM mirrors."""
    import torch
    from xrt_tpu_torch import histogram as th, runner
    from xrt_tpu_torch.oes import base as oebase
    f32, f64 = torch.float32, torch.float64
    n, reps = OE_NRAYS, OE_REPEATS
    src, cap, scr = cap_line(n, f32)

    def process(rng):
        glo, _ = cap.multiple_reflect(src.shine(rng),
                                      maxReflections=CAP_MAXR)
        return {'screen': scr.expose(glo)}

    def plot_fn():
        return oe_plot(dict(label='x', unit='mm', limits=(-1.5, 1.5)),
                       dict(label='z', unit='mm', limits=(-1.5, 1.5)),
                       dict(label='N reflections', unit='',
                            data='reflection_number', limits=(0, 8)))
    plot, pass_ms, med, launches, peak, rng = oe_passes(process, plot_fn,
                                                        reps, 71)
    route = th.plot_route((128,) * 3)
    check(launches == {f'hist_plot:{route}': reps},
          f'capillary: not one hist_plot launch a pass: {launches}')
    counts = []
    orig = oebase.find_intersection_dz

    def counted(dz_fn, *a, **k):
        evals = []

        def f(*xyz):
            evals.append(1)
            return dz_fn(*xyz)
        out = orig(f, *a, **k)
        counts.append(len(evals))
        return out
    oebase.find_intersection_dz = counted
    try:
        ms, (beam, (glo, loc), img, hists) = step_split([
            lambda: src.shine(rng),
            lambda b: cap.multiple_reflect(b, maxReflections=CAP_MAXR),
            lambda g: scr.expose(g[0]),
            lambda i: runner.histogram_plot(plot, {'screen': i})])
    finally:
        oebase.find_intersection_dz = orig
    reads = sum(c - 3 for c in counts)
    good = glo.state == 1
    J = (glo.Jss + glo.Jpp)[good]
    jmax = float(J.max())
    shares = bounce_shares(glo)
    print(f'phase 27 capillary (ellipsoid A {CAP_A:.0f}, B {CAP_B:.0f} mm, '
          f'Si), multiple_reflect up to {CAP_MAXR} bounces: {n} rays/pass, '
          f'float32, {reps} passes + calibration: '
          f'{", ".join(f"{v:.1f}" for v in pass_ms)} ms, median {med:.1f} '
          f'ms, {n / (med * 1e-3):.3e} rays/s; split (CUDA events): source '
          f'{ms[0]:.1f} ms, multiple_reflect {ms[1]:.1f} ms ({len(counts)} '
          f'searches, {reads} host reads), expose {ms[2]:.1f} ms, histograms '
          f'{ms[3]:.2f} ms; flux {plot.intensity:.6g}, mean bounces '
          f'{plot.cE:.3f}; peak device memory {peak / 2 ** 30:.2f} GiB; '
          f'launches {launches}', flush=True)
    print(f'phase 27 bounce counts 0..{CAP_MAXR}, share of the rays: '
          f'{", ".join(f"{s:.4f}" for s in shares)}; the largest J of a good '
          f'ray {jmax:.7f} (limit 1 + 1e-6)', flush=True)
    check(jmax <= 1 + 1e-6 and sum(shares[2:]) > 0.05,
          f'capillary: J {jmax}, bounces {shares}')
    args = oe_hist_plot_check(27, 'capillary', plot, {'screen': img})
    timing['capillary'] = dict(launches=launches, plot_args=args)
    del beam, glo, loc, img, hists
    res = {}
    for dt in (f32, f64):
        s_, c_, _ = cap_line(OE_CROSS_NRAYS, dt)
        res[dt] = bounce_shares(c_.multiple_reflect(
            s_.shine(torch.Generator().manual_seed(72)),
            maxReflections=CAP_MAXR)[0])
    diff = 0.5 * sum(abs(a - b) for a, b in zip(res[f32], res[f64]))
    print(f'phase 27 capillary float32 vs float64, {OE_CROSS_NRAYS} rays, '
          f'bounce shares {", ".join(f"{s:.4f}" for s in res[f32])} / '
          f'{", ".join(f"{s:.4f}" for s in res[f64])}: rays counted apart '
          f'{diff:.2e} (limit {CAP_F32_LIMIT:.0e})', flush=True)
    check(diff < CAP_F32_LIMIT, f'capillary float32 vs float64: {diff}')
    conic_checks()


#: examples/17_stl_mesh.py: the cylinder's STL mesh (30 x 500 mm, 25 x 201
#: vertices) for a Rh mirror at 10 m focusing at 2 m, 4 mrad
MESH_SPLINE_PER_MM = 2.0


def write_cylinder_stl(path, R, lx=30.0, ly=500.0, nx=25, ny=201):
    """A binary STL of the meridional cylinder z = y^2 / (2R) with a floor
    (examples/17_stl_mesh.py)."""
    import struct
    import numpy as np
    xs = np.linspace(-lx / 2, lx / 2, nx)
    ys = np.linspace(-ly / 2, ly / 2, ny)
    X, Y = np.meshgrid(xs, ys, indexing='ij')
    Z = Y ** 2 / (2 * R)
    tris = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            p = [[X[i, j], Y[i, j], Z[i, j]],
                 [X[i + 1, j], Y[i + 1, j], Z[i + 1, j]],
                 [X[i, j + 1], Y[i, j + 1], Z[i, j + 1]],
                 [X[i + 1, j + 1], Y[i + 1, j + 1], Z[i + 1, j + 1]]]
            tris.append([p[0], p[1], p[3]])
            tris.append([p[0], p[3], p[2]])
    zb = Z.min() - 2.0
    tris.append([[xs[0], ys[0], zb], [xs[-1], ys[0], zb],
                 [xs[-1], ys[-1], zb]])
    tris.append([[xs[0], ys[0], zb], [xs[-1], ys[-1], zb],
                 [xs[0], ys[-1], zb]])
    v = np.asarray(tris, float)
    nrm = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-30)
    with open(path, 'wb') as f:
        f.write(b'\0' * 80)
        f.write(struct.pack('<I', len(v)))
        for tri, nn in zip(v, nrm):
            f.write(struct.pack('<3f', *nn))
            for pt in tri:
                f.write(struct.pack('<3f', *pt))
            f.write(struct.pack('<H', 0))


def mesh_line(nrays, dtype, path, hint):
    """examples/17_stl_mesh.py: the GeometricSource of example 11 -> the
    STL mirror (*hint* 'quad' or 'spline') -> screen at the focus."""
    from xrt_tpu_torch.materials import Material
    from xrt_tpu_torch.oes import MeshOE
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import GeometricSource
    dk = dict(dtype=dtype, device='cuda')
    P, Q, th = FE_P, FE_Q, FE_PITCH
    mirror = MeshOE.create(
        fileName=path, center=(0, P, 0), pitch=th, surfaceHint=hint,
        gridPointsPerMM=MESH_SPLINE_PER_MM,
        material=Material.create('Rh', rho=12.41, **dk),
        limPhysX=(-14, 14), limPhysY=(-240, 240), **dk)
    src = GeometricSource.create(
        nrays=nrays, dx=0.1, dz=0.05, dxprime=3e-5, dzprime=3e-5,
        distE='lines', energies=(FE_E0,), polarization='horizontal', **dk)
    return src, mirror, Screen.create(center=(0, P + Q, 2 * th * Q))


def phase_mesh(timing):
    """Phase 28: the STL mesh mirror of examples/17_stl_mesh.py."""
    import os
    import tempfile
    import torch
    from xrt_tpu_torch import histogram as th, runner
    f32, f64 = torch.float32, torch.float64
    n, reps = OE_NRAYS, OE_REPEATS
    P, Q, thp = FE_P, FE_Q, FE_PITCH
    R = 2 * P * Q / (P + Q) / math.sin(thp)
    route = th.plot_route((128,) * 3)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, 'mirror.stl')
        write_cylinder_stl(path, R)
        for seed, hint in enumerate(('quad', 'spline')):
            t0 = time.perf_counter()
            src, mirror, scr = mesh_line(n, f32, path, hint)
            t_build = time.perf_counter() - t0

            def process(rng):
                return {'screen': scr.expose(
                    mirror.reflect(src.shine(rng))[0])}

            def plot_fn():
                return oe_plot(dict(label='x', unit='mm', limits=(-1, 1)),
                               dict(label='z', unit='mm',
                                    limits=(-0.1, 0.1)),
                               dict(label='energy', unit='eV',
                                    limits=(FE_E0 - 1, FE_E0 + 1)))
            plot, pass_ms, med, launches, peak, rng = oe_passes(
                process, plot_fn, reps, 80 + seed)
            check(launches == {f'hist_plot:{route}': reps},
                  f'mesh {hint}: not one hist_plot launch a pass: '
                  f'{launches}')
            ms, (beam, (glo, loc), img, hists) = step_split([
                lambda: src.shine(rng), lambda b: mirror.reflect(b),
                lambda g: scr.expose(g[0]),
                lambda i: runner.histogram_plot(plot, {'screen': i})])
            good = (img.state == 1)
            zs = float(img.z.double()[good].std())
            xs = float(img.x.double()[good].std())
            unfocused = 3e-5 * (P + Q)
            extra = ''
            if hint == 'quad':
                Rmer = float(mirror.fitted_radii()[0])
                extra = (f'; fitted meridional radius {Rmer:.6g} mm '
                         f'({abs(Rmer / R - 1):.2e} of {R:.6g}; limit 1e-2)')
                check(abs(Rmer / R - 1) < 1e-2, f'mesh radius {Rmer}')
            print(f'phase 28 STL mesh mirror ({hint}; built in '
                  f'{t_build:.2f} s on the host): {n} rays/pass, float32, '
                  f'{reps} passes + calibration: '
                  f'{", ".join(f"{v:.1f}" for v in pass_ms)} ms, median '
                  f'{med:.1f} ms, {n / (med * 1e-3):.3e} rays/s; split (CUDA '
                  f'events): source {ms[0]:.1f} ms, reflect {ms[1]:.1f} ms, '
                  f'expose {ms[2]:.1f} ms, histograms {ms[3]:.2f} ms; good '
                  f'{float(good.double().mean()):.4f}; image z std '
                  f'{zs:.4e} mm (limit 0.1 x the unfocused '
                  f'{unfocused:.3f}), x std {xs:.4f} mm{extra}; peak device '
                  f'memory {peak / 2 ** 30:.2f} GiB; launches {launches}',
                  flush=True)
            check(float(good.double().mean()) > 0.9 and zs < 0.1 * unfocused,
                  f'mesh {hint} focus: {zs}')
            args = oe_hist_plot_check(28, f'mesh {hint}', plot,
                                      {'screen': img})
            timing[f'mesh:{hint}'] = dict(launches=launches, plot_args=args)
            del beam, glo, loc, img, hists
        res = {}
        for dt in (f32, f64):
            s_, m_, sc_ = mesh_line(OE_CROSS_NRAYS, dt, path, 'spline')
            im = sc_.expose(m_.reflect(s_.shine(
                torch.Generator().manual_seed(82)))[0])
            g = im.state == 1
            res[dt] = (float(im.z.double()[g].mean()),
                       float(im.z.double()[g].std()))
    (m32, s32), (m64, s64) = res[f32], res[f64]
    print(f'phase 28 spline mesh float32 vs float64, {OE_CROSS_NRAYS} rays: '
          f'image z mean {m32:.4e} / {m64:.4e} mm ({abs(m32 - m64):.2e}; '
          f'limit 1e-3 mm), std {s32:.4e} / {s64:.4e} '
          f'({abs(s32 / s64 - 1):.2e}; limit 1e-2)', flush=True)
    check(abs(m32 - m64) < 1e-3 and abs(s32 / s64 - 1) < 1e-2,
          f'mesh float32 vs float64: {res}')


#: examples/18_txm.py: energy, the plate's distance, the object's side
#: (mm) and voxels a side
TXM_E0, TXM_P, TXM_SIZE, TXM_N = 9000.0, 1000.0, 0.05, 40


def txm_line(nrays, dtype, uniform=False):
    """examples/18_txm.py: a flat parallel 80 um beam -> a Plate of t 50 um
    carrying a 40^3 voxel grid (water with a gold cross; all water with
    *uniform*) -> a detector 100 mm on.  The grid spans z in [0, t], the
    volume's frame (``materials/volume.py``: the entry surface at z = 0);
    the example's [-t/2, t/2] would leave half of each chord outside it."""
    import numpy as np
    from xrt_tpu_torch.materials import Material, TXMMaterial
    from xrt_tpu_torch.oes import Plate
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import GeometricSource
    dk = dict(dtype=dtype, device='cuda')
    water = Material.create(('H', 'O'), quantities=(2, 1), rho=1.0,
                            kind='plate', **dk)
    gold = Material.create('Au', rho=19.3, kind='plate', **dk)
    n, S = TXM_N, TXM_SIZE
    grid = np.zeros((n, n, n), np.uint8)
    if not uniform:
        grid[:, n // 2 - 4:n // 2 + 4, n // 4:3 * n // 4] = 1
        grid[:, n // 4:3 * n // 4, n // 2 - 4:n // 2 + 4] = 1
    lim = {'x': (-S / 2, S / 2), 'y': (-S / 2, S / 2), 'z': (0.0, S)}
    txm = TXMMaterial.create(indexGrid=grid.transpose(2, 1, 0), limits=lim,
                             materialsIndex=(water, gold), device='cuda')
    kw = dict(center=(0, TXM_P, 0), pitch=math.pi / 2, t=S,
              limPhysX=(-S, S), limPhysY=(-S, S))
    plate = Plate.create(material=txm, **kw)
    src = GeometricSource.create(
        nrays=nrays, distx='flat', dx=S * 1.6, distz='flat', dz=S * 1.6,
        distxprime=None, distzprime=None, dxprime=0.0, dzprime=0.0,
        distE='lines', energies=(TXM_E0,), polarization='horizontal', **dk)
    return (src, plate, Screen.create(center=(0, TXM_P + 100.0, 0)),
            Plate.create(material=water, **kw))


def mean_flux(glo):
    import torch
    good = glo.state == 1
    return float(torch.where(good, glo.Jss + glo.Jpp,
                             torch.zeros_like(glo.Jss)).double().sum() /
                 good.sum())


def phase_txm(timing):
    """Phase 29: the TXM voxel volume of examples/18_txm.py."""
    import torch
    from xrt_tpu_torch import histogram as th, runner
    f32, f64 = torch.float32, torch.float64
    n, reps = OE_NRAYS, OE_REPEATS
    src, plate, det, _ = txm_line(n, f32)

    def process(rng):
        return {'screen': det.expose(plate.double_refract(src.shine(rng))[0])}

    def plot_fn():
        return oe_plot(dict(label='x', unit='um', limits=(-40, 40)),
                       dict(label='z', unit='um', limits=(-40, 40)),
                       dict(label='energy', unit='eV',
                            limits=(TXM_E0 - 1, TXM_E0 + 1)))
    plot, pass_ms, med, launches, peak, rng = oe_passes(process, plot_fn,
                                                        reps, 90)
    route = th.plot_route((128,) * 3)
    check(launches == {f'hist_plot:{route}': reps},
          f'TXM: not one hist_plot launch a pass: {launches}')
    with _Timed(plate.material, 'volume_integrals') as tv:
        ms, (beam, glo, img, hists) = step_split([
            lambda: src.shine(rng), lambda b: plate.double_refract(b)[0],
            lambda g: det.expose(g),
            lambda i: runner.histogram_plot(plot, {'screen': i})])
    v_ms = tv.ms()
    nk = profiled_kernel_count(lambda: plate.double_refract(beam))
    I = (glo.Jss + glo.Jpp).double()
    good = glo.state == 1
    dark = float((good & (I < 0.1)).double().sum() / good.sum())
    print(f'phase 29 TXM ({TXM_N}^3 voxels, water with a gold cross, a '
          f'{TXM_SIZE * 1e3:.0f} um plate): {n} rays/pass, float32, {reps} '
          f'passes + calibration: {", ".join(f"{v:.1f}" for v in pass_ms)} '
          f'ms, median {med:.1f} ms, {n / (med * 1e-3):.3e} rays/s; split '
          f'(CUDA events): source {ms[0]:.1f} ms, double_refract '
          f'{ms[1]:.1f} ms (the chord integrals over {TXM_N} slabs '
          f'{v_ms:.1f} ms; {nk} kernel launches a double_refract, '
          f'torch.profiler), expose {ms[2]:.1f} ms, histograms {ms[3]:.2f} '
          f'ms; flux {plot.intensity:.6g}, nGood {plot.nRaysGood}, the gold '
          f'cross\'s shadow (J < 0.1) {dark:.4f} of the good rays; peak '
          f'device memory {peak / 2 ** 30:.2f} GiB; launches {launches}',
          flush=True)
    check(0.05 < dark < 0.5, f'TXM shadow {dark}')
    args = oe_hist_plot_check(29, 'TXM', plot, {'screen': img})
    timing['txm'] = dict(launches=launches, plot_args=args)
    del beam, glo, img, hists
    s_, p_, _, plain = txm_line(OE_CROSS_NRAYS, f32, uniform=True)
    b_ = s_.shine(torch.Generator().manual_seed(91))
    tv_, tp_ = mean_flux(p_.double_refract(b_)[0]), \
        mean_flux(plain.double_refract(b_)[0])
    print(f'phase 29 a uniform water grid against the plain water plate, '
          f'{OE_CROSS_NRAYS} rays, float32: transmission {tv_:.7f} / '
          f'{tp_:.7f} ({abs(tv_ / tp_ - 1):.2e}; limit 1e-3)', flush=True)
    check(abs(tv_ / tp_ - 1) < 1e-3, f'TXM uniform {tv_} vs plain {tp_}')
    res = {}
    for dt in (f32, f64):
        s_, p_, _, _ = txm_line(OE_CROSS_NRAYS, dt)
        res[dt] = mean_flux(p_.double_refract(
            s_.shine(torch.Generator().manual_seed(92)))[0])
    e = abs(res[f32] / res[f64] - 1)
    print(f'phase 29 TXM float32 vs float64, {OE_CROSS_NRAYS} rays: mean '
          f'transmission {res[f32]:.7f} / {res[f64]:.7f} ({e:.2e}; limit '
          f'1e-4)', flush=True)
    check(e < 1e-4, f'TXM float32 vs float64 {e}')


# ---------------------------------------------------------------------------
# the source integrals, the quadrature search, layouts, catalogs, stages
# ---------------------------------------------------------------------------

#: BASELINE configuration 3's undulator (tests/test_baseline_configs.py:24),
#: also examples/02_undulator_dcm_kb.py's without gNodes
C3_UND = dict(eE=3.0, eI=0.5, period=18.0, n=111, targetE=(DCM_E0, 7),
              eEpsilonX=0.263, eEpsilonZ=0.008, betaX=9.0, betaZ=2.0,
              xPrimeMax=0.02, zPrimeMax=0.02, eMin=DCM_E0 - 40,
              eMax=DCM_E0 + 40)
#: 1e5 rays a pass: at 2e5 a near-field pass took 5.1 s on an H100 (the
#: integral runs 111 periods where the far field runs one)
C3_NRAYS, C3_REPEATS, C3_CROSS_NRAYS = 100_000, 4, 20_000
C3_TAPER = (1.09, 11.0)
#: float32 against float64 on the rays both resample alike: the flux per
#: ray (relative), the weighted mean energy (eV); and the candidates'
#: intensities on the same candidates (of the largest)
C3_F32_FLUX, C3_F32_E, C3_F32_MAP = 1e-3, 0.01, 1e-3
UND_GOLDEN = 'tests/golden/ref_undulator.npz'
#: tests/test_undulator.py's source, cut to 10 periods for its taper and
#: near-field goldens
UND_GOLDEN_ARGS = dict(nrays=1000, eE=6.0, eI=0.1, eEpsilonX=0.0,
                       eEpsilonZ=0.0, period=33.0, n=10, K=1.5, eMin=9000,
                       eMax=9600, xPrimeMax=0.02, zPrimeMax=0.02,
                       gNodes=120, gIntervals=2)
CF_GOLDEN = 'tests/golden/ref_customfield.npz'
CF_NF_GOLDEN = 'tests/golden/ref_customfield_nf.npz'
#: tests/test_customfield.py's periodic field source (make_sff)
CF_ARGS = dict(eE=6.0, eI=0.1, eEpsilonX=0.0, eEpsilonZ=0.0, eMin=5000,
               eMax=6500, xPrimeMax=0.05, zPrimeMax=0.05, gNodes=3000,
               gIntervals=2)
CF_NRAYS, CF_REPEATS, CF_P = 1_000_000, 2, 20000.0
#: examples/22_edge_radiation.py at its own sizes
ER_NPT, ER_GNODES, ER_R0 = 101, 3000, 2500.0


def repo_file(path):
    import os
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), path)


def allclose(got, want, rtol, atol):
    """numpy's assert_allclose condition, as a bool."""
    import numpy as np
    got, want = np.asarray(got), np.asarray(want)
    return bool(np.all(np.abs(got - want) <= atol + rtol * np.abs(want)))


def config3_line(nrays, dtype, **kw):
    """BASELINE configuration 3: the undulator (gNodes 64; *kw*: R0 or
    taper) -> the Si(111) DCM at 30 m (fixed exit 20 mm) -> a screen 1 m
    after it."""
    from xrt_tpu_torch.materials import CrystalSi
    from xrt_tpu_torch.oes import DCM
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import Undulator
    dk = dict(dtype=dtype, device='cuda')
    und = Undulator.create(nrays=nrays, gNodes=64, **C3_UND, **kw, **dk)
    dcm = DCM.create(center=(0, DCM_P, 0),
                     material=CrystalSi.create(hkl=(1, 1, 1), **dk),
                     alignE=DCM_E0, fixedOffset=20.0, limPhysX=(-50, 50),
                     limPhysY=(-500, 500))
    scr = Screen.create(center=(0, DCM_P + 1000.0, 20.0))
    return und, dcm, scr


def c3_plot():
    return oe_plot(dict(label='x', unit='mm', limits=(-1, 1)),
                   dict(label='z', unit='mm', limits=(-1, 1)),
                   dict(label='energy', unit='eV',
                        limits=(DCM_E0 - 10, DCM_E0 + 10)))


def transmitted(mono):
    """The intensities of a DCM's exit beam (0 for rays it lost) and the
    mask of the rays above 1e-3 of the largest, float64."""
    import torch
    I = torch.where(mono.state == 1, mono.Jss + mono.Jpp,
                    torch.zeros_like(mono.Jss)).double()
    return I, I > 1e-3 * I.max()


def weighted_band(mono):
    """(weighted mean, weighted std) of the energy of the transmitted rays
    above 1e-3 of the peak, eV."""
    I, good = transmitted(mono)
    w, E = I[good], mono.E.double()[good]
    m = float((w * E).sum() / w.sum())
    return m, math.sqrt(float((w * (E - m) ** 2).sum() / w.sum()))


def phase_config3(timing):
    """Phase 30: BASELINE configuration 3 as named: the undulator in the
    near field at the DCM's 30 m, its far-field twin on the same draws and
    the tapered source, each through run_ray_tracing; the reference test's
    limits in float64; float32 against float64; the goldens' taper and
    near-field maps in float64."""
    t_phase = time.perf_counter()
    import numpy as np
    import torch
    from xrt_tpu_torch import histogram as th, runner
    from xrt_tpu_torch.sources import Undulator
    from xrt_tpu_torch.sources.undulator import RAY_BLOCK
    f32, f64 = torch.float32, torch.float64
    n = C3_NRAYS
    route = th.plot_route((128,) * 3)
    # the far-field twin draws what the near field draws; the tapered
    # source runs two passes without a warm-up
    for key, kw, reps, warm in (
            ('config3:near', dict(R0=DCM_P), C3_REPEATS, True),
            ('config3:far', {}, C3_REPEATS, True),
            ('config3:taper', dict(taper=C3_TAPER), 2, False)):
        und, dcm, scr = config3_line(n, f32, **kw)

        def process(rng, und=und, dcm=dcm, scr=scr):
            return {'screen': scr.expose(dcm.double_reflect(
                und.shine(rng), rng)[0])}
        plot, pass_ms, med, launches, peak, rng = oe_passes(
            process, c3_plot, reps, 30, warm=warm)
        check(launches == {f'hist_plot:{route}': reps},
              f'{key}: not one hist_plot launch a pass: {launches}')
        with _Timed(und, '_integrate') as ti:
            ms, (beam, mono, img, hists) = step_split([
                lambda: und.shine(rng),
                lambda b: dcm.double_reflect(b, rng)[0],
                lambda g: scr.expose(g),
                lambda i: runner.histogram_plot(plot, {'screen': i})])
        i_ms = ti.ms()
        g = torch.Generator('cuda').manual_seed(3)
        u = [torch.rand(RAY_BLOCK, generator=g, device='cuda')
             for _ in range(3)]
        cand = (u[0] * (und.eMax - und.eMin) + und.eMin,
                u[1] * (und.Theta_max - und.Theta_min) + und.Theta_min,
                u[2] * (und.Psi_max - und.Psi_min) + und.Psi_min)
        nk = profiled_kernel_count(lambda: und.build_I_map(g, *cand))
        busy = ''
        if key == 'config3:near':
            # the busy share of a pass of one ray block's candidates (a
            # pass is seven such blocks; the profiler's records of all
            # seven take longer to read than the pass)
            und1 = und.replace(nrays=RAY_BLOCK // und.oversample)
            host_ms = [0.0]

            def one_pass():
                t0 = time.perf_counter()
                scr.expose(dcm.double_reflect(und1.shine(rng), rng)[0])
                torch.cuda.synchronize()
                host_ms[0] = 1e3 * (time.perf_counter() - t0)
            dev_ms = profiled_device_ms(one_pass)
            busy = (f'; device busy {dev_ms:.1f} ms of a {host_ms[0]:.1f} '
                    f'ms pass of {und1.nrays} rays ({RAY_BLOCK} candidates) '
                    f'under the profiler ({dev_ms / host_ms[0]:.1%})')
        Em, band = weighted_band(mono)
        steps = (und.Np if key != 'config3:far' else 1) * \
            und.tg.shape[0] // 64
        print(f'phase 30 {key}: {n} rays/pass ({n * und.oversample} '
              f'undulator candidates, gNodes 64, {steps} node steps a ray '
              f'block), float32, {reps} passes (the first calibrates): '
              f'{", ".join(f"{v:.1f}" for v in pass_ms)} ms, median of the '
              f'others {med:.1f} ms, {n / (med * 1e-3):.3e} rays/s; split '
              f'(CUDA events): shine {ms[0]:.1f} ms (the integral '
              f'{i_ms:.1f} ms), double_reflect {ms[1]:.1f} ms, expose '
              f'{ms[2]:.1f} ms, histograms {ms[3]:.2f} ms; {nk} kernel '
              f'launches a build_I_map call of {RAY_BLOCK} rays '
              f'(torch.profiler){busy}; transmitted band {band:.3f} eV '
              f'about {Em:.3f} eV; peak device memory '
              f'{peak / 2 ** 30:.2f} GiB; launches {launches}', flush=True)
        check(0 < band < 10.0, f'{key}: band {band} eV')
        args = oe_hist_plot_check(30, key, plot, {'screen': img})
        timing[key] = dict(launches=launches, plot_args=args,
                           pass_ms=pass_ms, integral_ms=i_ms, kernels=nk)
        del beam, mono, img, hists
    # the reference test's limits in float64, and float32 against float64
    # on the same draws (a CPU generator: float64 draws cast to each dtype)
    res = {}
    for dt in (f32, f64):
        und, dcm, _ = config3_line(C3_CROSS_NRAYS, dt, R0=DCM_P)
        beam = und.shine(torch.Generator().manual_seed(31))
        res[dt] = (und, beam, dcm.double_reflect(beam)[0])
    und64, beam64, mono64 = res[f64]
    Em, band = weighted_band(mono64)
    I64, good = transmitted(mono64)
    par = float((mono64.b - beam64.b)[good].abs().max())
    print(f'phase 30 configuration 3 float64, {C3_CROSS_NRAYS} rays: band '
          f'{band:.4f} eV (limit 10), fixed exit parallel to {par:.2e} '
          f'(limit 1e-9), {int(good.sum())} rays above 1e-3 of the peak',
          flush=True)
    check(band < 10.0 and par < 1e-9 and int(good.sum()) > 100,
          f'configuration 3 float64: band {band}, parallel {par}')
    _, beam32, mono32 = res[f32]
    same = (beam32.E.double() - beam64.E).abs() < 1e-3
    I32, _ = transmitted(mono32)
    flux = float(I32[same].sum() / I64[same].sum() - 1)
    Ew = [float((I * m.E.double())[same].sum() / I[same].sum())
          for I, m in ((I32, mono32), (I64, mono64))]
    gcpu = torch.Generator().manual_seed(32)
    cand64 = [torch.rand(RAY_BLOCK, generator=gcpu, dtype=f64)
              for _ in range(3)]
    cand64 = (cand64[0] * 80 + DCM_E0 - 40,
              (cand64[1] - 0.5) * 2 * und64.Theta_max,
              (cand64[2] - 0.5) * 2 * und64.Psi_max)
    maps = {dt: res[dt][0].build_I_map(None, *(c.to(dt).to('cuda')
                                                for c in cand64))[0]
            for dt in (f32, f64)}
    map_err = float((maps[f32].double() - maps[f64]).abs().max() /
                    maps[f64].abs().max())
    print(f'phase 30 configuration 3 float32 vs float64 on the same draws: '
          f'{int((~same).sum())} of {C3_CROSS_NRAYS} rays resampled '
          f'otherwise (the float32 cumulative sum); on the others flux per '
          f'ray {flux:+.2e} (limit {C3_F32_FLUX}), weighted mean energy '
          f'{Ew[0] - Ew[1]:+.2e} eV (limit {C3_F32_E}); the near-field map '
          f'on {RAY_BLOCK} candidates max |dI| / max I {map_err:.2e} (limit '
          f'{C3_F32_MAP})', flush=True)
    check(abs(flux) < C3_F32_FLUX and abs(Ew[0] - Ew[1]) < C3_F32_E and
          map_err < C3_F32_MAP,
          f'configuration 3 float32: {flux}, {Ew}, {map_err}')
    # the goldens' taper and near-field maps, float64 on the card
    gold = np.load(repo_file(UND_GOLDEN))
    E, thg, psg = (torch.as_tensor(gold[k], device='cuda')
                   for k in ('und_E', 'und_theta', 'und_psi'))
    for tag, kw in (('undt', dict(taper=(1.09, 11.0))),
                    ('undn', dict(R0=5000.0))):
        src = Undulator.create(**UND_GOLDEN_ARGS, **kw, dtype=f64,
                               device='cuda')
        I, Es, Ep = (v.cpu().numpy() for v in src.build_I_map(None, E, thg,
                                                               psg))
        if tag == 'undt':
            ok = allclose(I, gold['undt_I'], 1e-6, 1e-3) and \
                allclose(Es, gold['undt_Es'], 1e-6, 1e-8) and \
                allclose(Ep, gold['undt_Ep'], 1e-6, 1e-8)
        else:
            Eh = gold['und_E']
            phase = np.ones_like(Es)
            for e in np.unique(Eh):
                sel = Eh == e
                zr = gold['undn_Es'][sel][0] / Es[sel][0]
                phase[sel] = zr / abs(zr)
            ok = allclose(I, gold['undn_I'], 1e-5, 1e-3) and \
                allclose(Es * phase, gold['undn_Es'], 1e-5, 1e4) and \
                allclose(Ep * phase, gold['undn_Ep'], 1e-5, 1e4)
        rel = float(np.abs(I - gold[tag + '_I']).max() /
                    np.abs(gold[tag + '_I']).max())
        print(f'phase 30 {UND_GOLDEN} {tag}_* float64: I max rel '
              f'{rel:.2e}, within tests/test_undulator.py\'s limits {ok}',
              flush=True)
        check(ok, f'{tag} golden')
    print(f'phase 30 took {time.perf_counter() - t_phase:.1f} s',
          flush=True)


def phase_search(timing):
    """Phase 31: the quadrature search on examples/02_undulator_dcm_kb.py's
    undulator (gNodes=None), against the port's own CPU float64 search,
    then one configuration-4 pass at 1e6 rays on its grid."""
    t_phase = time.perf_counter()
    import torch
    from xrt_tpu_torch import histogram as th
    from xrt_tpu_torch.sources import Undulator
    probes = []
    orig = Undulator._intensity_probe

    def counted(self):
        probes.append(1)
        return orig(self)
    Undulator._intensity_probe = counted
    try:
        out = {}
        for dev, dt in (('cuda', torch.float32), ('cpu', torch.float64)):
            probes.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            und = Undulator.create(nrays=C4_NRAYS, **C3_UND, dtype=dt,
                                   device=dev)
            torch.cuda.synchronize()
            out[dev] = (und.quadm, len(probes),
                        time.perf_counter() - t0)
    finally:
        Undulator._intensity_probe = orig
    (qc, pc, tc), (qh, ph, thh) = out['cuda'], out['cpu']
    print(f'phase 31 the quadrature search (gp 1e-6, probes in float64): '
          f'on the card quadm {qc} after {pc} probes, {pc} host reads, '
          f'{tc:.3f} s; on the CPU quadm {qh} after {ph} probes, '
          f'{thh:.3f} s', flush=True)
    check(qc == qh, f'search: card {qc} vs CPU {qh}')
    bl = config4_line(C4_NRAYS, torch.float32, gNodes=None)
    check(bl['source'].quadm == qc, 'configuration 4 search')

    def process(rng):
        beam = bl['source'].shine(rng)
        mono = bl['dcm'].double_reflect(beam, rng)[0]
        b2 = bl['hfm'].reflect(bl['vfm'].reflect(mono, rng)[0], rng)[0]
        return {'screen': bl['focus'].expose(b2)}

    def plot_fn():
        return oe_plot(dict(label='x', unit='um', limits=(-20, 20),
                            factor=1e3),
                       dict(label='z', unit='um', limits=(-20, 20),
                            factor=1e3),
                       dict(label='energy', unit='eV',
                            limits=(DCM_E0 - 3, DCM_E0 + 3)))
    plot, pass_ms, med, launches, peak, rng = oe_passes(process, plot_fn,
                                                        2, 17)
    c4 = timing['config4']['pass_ms']
    print(f'phase 31 configuration 4 on the searched grid (quadm {qc}, '
          f'{bl["source"].tg.shape[0]} nodes): {C4_NRAYS} rays, the '
          f'calibrating pass and one more '
          f'{", ".join(f"{v:.1f}" for v in pass_ms)} ms (phase 17 at '
          f'gNodes 64: {", ".join(f"{v:.1f}" for v in c4)} ms); flux '
          f'{plot.intensity:.6g}, FWHM x {plot.dx:.3f} um, z '
          f'{plot.dy:.3f} um; launches {launches}', flush=True)
    check(plot.intensity > 0 and launches == {
        f'hist_plot:{th.plot_route((128,) * 3)}': 2},
        f'search pass: {plot.intensity}, {launches}')
    img = process(rng)['screen']
    args = oe_hist_plot_check(31, 'configuration 4 (searched grid)', plot,
                              {'screen': img})
    timing['config4:search'] = dict(launches=launches, plot_args=args,
                                    quadm=qc, probes=pc, search_s=tc)
    timing['search_line'] = bl
    print(f'phase 31 took {time.perf_counter() - t_phase:.1f} s',
          flush=True)


def two_dipole_field():
    """examples/22_edge_radiation.py's field: two dipoles' four edges."""
    import numpy as np
    B0, LBM, LS, W = 1.4, 600.0, 300.0, 20.0
    y = np.linspace(-(LS / 2 + LBM + 150), LS / 2 + LBM + 150, 8000)

    def edge(y0):
        return 0.5 * (1 + np.tanh((y - y0) / W))
    By = B0 * (edge(-LS / 2 - LBM) - edge(-LS / 2) + edge(LS / 2) -
               edge(LS / 2 + LBM))
    return np.vstack([y, By]).T


def periodic_field():
    """tests/test_customfield.py's field: K 4.4, 53.96 mm, 41 periods."""
    import numpy as np
    from xrt_tpu_torch.physconsts import K2B
    K, L0, Np = 4.4, 53.96, 41
    zg = np.linspace(-L0 * Np * 0.5, L0 * Np * 0.5, 1000 * Np)
    return np.vstack([zg, K2B * K / L0 * np.sin(2 * np.pi * zg / L0)]).T


def phase_customfield(timing):
    """Phase 32: example 22's edge radiation at its own sizes in float64
    and float32, the custom-field goldens in float64, and the periodic
    test field's ray-mode shine through run_ray_tracing."""
    t_phase = time.perf_counter()
    import numpy as np
    import torch
    from xrt_tpu_torch import histogram as th
    from xrt_tpu_torch.physconsts import CH
    from xrt_tpu_torch.screens import Screen
    from xrt_tpu_torch.sources import SourceFromField
    f32, f64 = torch.float32, torch.float64
    E0 = CH / 1e5
    t0 = time.perf_counter()
    er = SourceFromField.create(
        nrays=100, eE=2.75, eI=0.5, eEpsilonX=0.0, eEpsilonZ=0.0,
        customField=two_dipole_field(), eMin=E0 * 0.98, eMax=E0 * 1.02,
        xPrimeMax=15.0, zPrimeMax=15.0, gNodes=ER_GNODES, gIntervals=6,
        R0=ER_R0, dtype=f64, device='cuda')
    create_s = time.perf_counter() - t0
    xs = np.linspace(-20.0, 20.0, ER_NPT)
    th_, ps_ = np.meshgrid(np.arctan(xs / ER_R0), np.arctan(xs / ER_R0),
                           indexing='ij')
    maps, map_ms = {}, {}
    for dt in (f64, f32):
        args = [torch.as_tensor(v, dtype=dt, device='cuda') for v in
                (np.full(th_.size, E0), th_.ravel(), ps_.ravel())]
        er.build_I_map(None, *args)
        ms, (out,) = step_split([lambda: er.build_I_map(None, *args)])
        map_ms[dt] = ms[0]
        Is = (out[1].abs() ** 2).double().reshape(ER_NPT, ER_NPT)
        Ip = (out[2].abs() ** 2).double().reshape(ER_NPT, ER_NPT)
        maps[dt] = (out[0].double(), Is, Ip)
        c = ER_NPT // 2
        ih = float(Is[:, c].sum() / Ip[:, c].sum().clamp(min=1e-30))
        pv = float(Ip[c, :].sum() / Ip[:, c].sum().clamp(min=1e-30))
        print(f'phase 32 example 22 edge radiation ({ER_NPT}^2 pixels, '
              f'R0 {ER_R0} mm, {er.tg.shape[0]} nodes, {dt}): the map '
              f'{map_ms[dt]:.1f} ms (CUDA events; the field and trajectory '
              f'on the host {create_s:.2f} s); s/p along the horizontal '
              f'axis {ih:.3g} (> 3), p vertical / horizontal {pv:.3g} '
              f'(> 10)', flush=True)
        check(ih > 3 and pv > 10, f'edge radiation {dt}: {ih}, {pv}')
    d = float((maps[f32][0] - maps[f64][0]).abs().max() /
              maps[f64][0].abs().max())
    print(f'phase 32 example 22 float32 against float64: max |dI| / max I '
          f'{d:.3e} (the node phase wc (tg - trajz) keeps ulp(tg) x wc in '
          f'float32: ROADMAP C22)', flush=True)
    timing['edge_f32'] = d
    # the goldens, float64 on the card
    sff = SourceFromField.create(customField=periodic_field(), nrays=100,
                                 **CF_ARGS, dtype=f64, device='cuda')
    for path, R0 in ((CF_GOLDEN, None), (CF_NF_GOLDEN, 'golden')):
        g = np.load(repo_file(path))
        src = sff.replace(R0=None if R0 is None else float(g['R0']))
        I, Es, Ep = (v.cpu().numpy() for v in src.build_I_map(
            None, *(torch.as_tensor(g[k], device='cuda')
                    for k in ('sff_E', 'sff_theta', 'sff_psi'))))
        ok = allclose(I, g['sff_I'], 2e-4, 0) and \
            allclose(Es, g['sff_Es'], 2e-4, 1e-8) and \
            allclose(Ep, g['sff_Ep'], 2e-4, 1e-8)
        rel = float(np.abs(I - g['sff_I']).max() / np.abs(g['sff_I']).max())
        print(f'phase 32 {path} float64: I max rel {rel:.2e}, within rtol '
              f'2e-4 {ok}', flush=True)
        check(ok, f'{path}')
    # the periodic field's ray-mode shine into a screen
    src = sff.replace(nrays=CF_NRAYS, oversample=2, dtype=f32,
                      device='cuda')
    scr = Screen.create(center=(0, CF_P, 0))

    def process(rng):
        return {'screen': scr.expose(src.shine(rng))}

    def plot_fn():
        return oe_plot(dict(label='x', unit='mm', limits=(-1.5, 1.5)),
                       dict(label='z', unit='mm', limits=(-1.5, 1.5)),
                       dict(label='energy', unit='eV', limits=(5000, 6500)))
    plot, pass_ms, med, launches, peak, rng = oe_passes(process, plot_fn,
                                                        CF_REPEATS, 32)
    with _Timed(src, 'build_I_map') as tb:
        ms, (img,) = step_split([lambda: process(rng)['screen']])
    print(f'phase 32 the periodic field\'s shine ({src.tg.shape[0]} nodes, '
          f'{CF_NRAYS} rays from {CF_NRAYS * 2} candidates) into a screen '
          f'at {CF_P:.0f} mm, float32, {CF_REPEATS} passes (the first '
          f'calibrates): {", ".join(f"{v:.1f}" for v in pass_ms)} ms, '
          f'{CF_NRAYS / (med * 1e-3):.3e} rays/s; the integral '
          f'{tb.ms():.1f} ms of a {ms[0]:.1f} ms shine + expose; flux '
          f'{plot.intensity:.6g}, nGood {plot.nRaysGood}; peak device '
          f'memory {peak / 2 ** 30:.2f} GiB; launches {launches}',
          flush=True)
    check(plot.intensity > 0 and launches == {
        f'hist_plot:{th.plot_route((128,) * 3)}': CF_REPEATS},
        f'custom field shine: {plot.intensity}, {launches}')
    args = oe_hist_plot_check(32, 'custom-field', plot, {'screen': img})
    timing['customfield'] = dict(launches=launches, plot_args=args)
    print(f'phase 32 took {time.perf_counter() - t_phase:.1f} s',
          flush=True)


def layout_pass(bl, seed, plot_fn):
    """One run_ray_tracing pass of *bl*'s flow (``propagate_flow``) with a
    generator of *seed*: the plot."""
    import torch
    from xrt_tpu_torch import runner
    plot = plot_fn()
    runner.run_ray_tracing(
        plot, repeats=1, rng=torch.Generator('cuda').manual_seed(seed),
        run_process=lambda b_, rng: {
            'screen': bl.propagate_flow(rng)['focus']})
    return plot


def phase_layouts(timing):
    """Phase 33: phase 31's beamline written to JSON and XML, loaded and
    traced bit-identically; a catalog Ge(111) DCM; the DCM on a tripod at
    nominal jacks against the DCM."""
    t_phase = time.perf_counter()
    import numpy as np
    import torch
    from xrt_tpu_torch import histogram as th
    from xrt_tpu_torch.beamline import BeamLine
    from xrt_tpu_torch.materials import catalogs
    from xrt_tpu_torch.oes import DCM, DCMOnTripodWithOneXStage
    from xrt_tpu_torch.stages import Tripod
    f32, f64 = torch.float32, torch.float64
    bl = timing['search_line']

    def plot_fn():
        return oe_plot(dict(label='x', unit='um', limits=(-20, 20),
                            factor=1e3),
                       dict(label='z', unit='um', limits=(-20, 20),
                            factor=1e3),
                       dict(label='energy', unit='eV',
                            limits=(DCM_E0 - 3, DCM_E0 + 3)))
    ref = layout_pass(bl, 33, plot_fn)
    keys = ('total1D_x', 'total1D_y', 'total1D_c', 'total2D',
            'total2D_RGB')
    for fmt in ('json', 'xml'):
        t0 = time.perf_counter()
        text = getattr(bl, 'export_to_' + fmt)()
        timing[f'layout_{fmt}'] = text
        back = getattr(BeamLine, 'load_from_' + fmt)(text, dtype=f32,
                                                     device='cuda')
        load_s = time.perf_counter() - t0
        got = layout_pass(back, 33, plot_fn)
        same = all(np.array_equal(np.asarray(getattr(got, k)),
                                  np.asarray(getattr(ref, k))) for k in keys)
        print(f'phase 33 the configuration-4 beamline as {fmt.upper()} '
              f'({len(text)} characters; written and loaded in '
              f'{load_s:.2f} s, the undulator\'s search again): one pass of '
              f'{C4_NRAYS} rays, histograms bit-identical to the original '
              f'beamline\'s {same} (flux {got.intensity:.6g} / '
              f'{ref.intensity:.6g})', flush=True)
        check(same and ref.intensity > 0, f'{fmt} layout trace')
    # a catalog crystal in the DCM: Ge(111) against Si(111) on the same rays
    bands = {}
    for name in ('Si', 'Ge'):
        src, dcm, scr, _ = dcm_trace_line(OE_NRAYS, f32)
        cr = catalogs.crystal(name, hkl=(1, 1, 1), dtype=f32, device='cuda')
        dcm = DCM.create(center=(0, DCM_P, 0), material=cr, alignE=DCM_E0,
                         fixedOffset=20.0, limPhysX=(-50, 50),
                         limPhysY=(-500, 500))

        def process(rng, src=src, dcm=dcm, scr=scr):
            return {'screen': scr.expose(dcm.double_reflect(
                src.shine(rng), rng)[0])}
        plot, pass_ms, med, launches, peak, rng = oe_passes(
            process, lambda: dcm_plot(), 2, 34)
        mono = dcm.double_reflect(src.shine(rng), rng)[0]
        Em, band = weighted_band(mono)
        bands[name] = band
        print(f'phase 33 catalogs.crystal({name!r}, hkl=(1, 1, 1)) in the '
              f'DCM (d {float(cr.d):.5f} A), {OE_NRAYS} rays/pass, float32: '
              f'pass {", ".join(f"{v:.1f}" for v in pass_ms)} ms; '
              f'transmitted band {band:.4f} eV about {Em:.3f} eV; flux '
              f'{plot.intensity:.6g}; launches {launches}', flush=True)
        check(abs(Em - DCM_E0) < 1.0 and plot.intensity > 0 and
              launches == {f'hist_plot:{th.plot_route((128,) * 3)}': 2},
              f'{name} DCM: {Em}, {plot.intensity}, {launches}')
        if name == 'Ge':
            img = process(rng)['screen']
            args = oe_hist_plot_check(33, 'Ge DCM', plot, {'screen': img})
            timing['catalog:Ge'] = dict(launches=launches, plot_args=args)
    print(f'phase 33 Ge(111) / Si(111) transmitted band '
          f'{bands["Ge"] / bands["Si"]:.3f} (limit > 1.5: Ge\'s Darwin '
          f'width is the wider)', flush=True)
    check(bands['Ge'] > 1.5 * bands['Si'], f'Ge vs Si bands {bands}')
    # the DCM on a tripod and one x stage at nominal jacks, float64
    jacks = [[-100.0, -100.0, 0.0], [100.0, -100.0, 0.0], [0.0, 100.0, 0.0]]
    center = [0.0, DCM_P, 0.0]
    tp = Tripod(*[list(j) for j in jacks], center=list(center), height=0.0)
    tp.set_jacks(pitch=0.0, roll=0.0)
    src, _, _, _ = dcm_trace_line(OE_CROSS_NRAYS, f64)
    cr = catalogs.crystal('Si', hkl=(1, 1, 1), dtype=f64, device='cuda')
    kw = dict(material=cr, alignE=DCM_E0, fixedOffset=20.0,
              limPhysX=(-50, 50), limPhysY=(-500, 500))
    tri = DCMOnTripodWithOneXStage(jack1=tp.jack1, jack2=tp.jack2,
                                   jack3=tp.jack3, dx=0.0, center=center,
                                   height=0.0, **kw)
    dcm = DCM.create(center=tuple(center), **kw)
    beam = src.shine(torch.Generator('cuda').manual_seed(35))
    a, b = tri.double_reflect(beam)[0], dcm.double_reflect(beam)[0]
    diff = max(float((getattr(a, f) - getattr(b, f)).abs().max())
               for f in ('x', 'z', 'a', 'b', 'c', 'Jss', 'Jpp'))
    states = bool(torch.equal(a.state, b.state))
    print(f'phase 33 DCMOnTripodWithOneXStage at nominal jacks against the '
          f'DCM, float64, {OE_CROSS_NRAYS} rays: max difference {diff:.2e} '
          f'(limit 1e-9), states equal {states}, '
          f'{int((a.state == 1).sum())} rays through', flush=True)
    check(diff < 1e-9 and states, f'tripod DCM: {diff}, {states}')
    print(f'phase 33 took {time.perf_counter() - t_phase:.1f} s',
          flush=True)


# ---------------------------------------------------------------------------
# phases 34-35: the multi-card layer and the command line
# ---------------------------------------------------------------------------

#: the chain's, the B2 hop's and the sharded gradient's limits in a world
#: of 2 (per-tile recentring changes float32 rounding only)
MC_CHAIN_LIMIT, MC_GRAD_LIMIT = 2e-5, 1e-5
MC_TRACE_SEED, MC_DP_SEED = 41, 43
MC_TIMEOUT = 400
#: phase 3's chain: samples a wave, screen pixels a side
MC_NRAYS, MC_NPIX = 200_000, 256


def _mc_plot_totals(plot):
    import numpy as np
    return {k: np.asarray(getattr(plot, k)) for k in
            ('total1D_x', 'total1D_y', 'total1D_c', 'total2D',
             'total2D_RGB', 'total1D_x_RGB', 'total1D_y_RGB',
             'total1D_c_RGB')} | {
        'intensity': np.asarray(plot.intensity),
        'nRaysAll': np.asarray(plot.nRaysAll),
        'nRaysGood': np.asarray(plot.nRaysGood)}


def _mc_counts(mesh):
    mesh.bytes_moved = mesh.host_bytes = mesh.collectives = 0


def _mc_bytes(mesh):
    return dict(bytes=mesh.bytes_moved, host_bytes=mesh.host_bytes,
                collectives=mesh.collectives)


def _mc_timed(fn, reps=2):
    """(median seconds of *reps* calls after a warm-up, last result)."""
    import torch
    out = fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), out


def multicard_paths(mesh):
    """This slice's paths on *mesh*, each against its unsharded run on the
    same card: phase 3's chain split over the ranks (destinations, and
    with the ring), phase 4's toroid -> screen hop on B2, phase 6's trace
    through ``run_ray_tracing(mesh=)``, the data-parallel pitch gradient of
    phase 12 (``sharded_trace``) and phase 9's chain gradient through the
    sharded chain.  Returns the numbers (times in s, errors, equality
    flags, launches, bytes moved)."""
    import numpy as np
    import torch
    from xrt_tpu_torch import histogram as th, parallel as par, runner
    from xrt_tpu_torch import waves as W
    from xrt_tpu_torch.ops import kirchhoff as tk
    from xrt_tpu_torch.wavechain import WaveChain
    W_, f32 = mesh.size, torch.float32
    out = dict(rank=mesh.rank, world=W_, backend=mesh.backend,
               host_staged=mesh.host_staged)

    def intensity(run):
        w, logs = run(torch.Generator().manual_seed(2))
        return WaveChain.absolute_intensity(w, logs)

    # the chain: unsharded, destinations split, and the ring
    run, els = build_chain(MC_NRAYS, MC_NPIX, f32)
    runs = {'single': run,
            'mesh': build_chain(MC_NRAYS, MC_NPIX, f32, mesh=mesh)[0],
            'ring': build_chain(MC_NRAYS, MC_NPIX, f32, mesh=mesh,
                                ring=True)[0]}
    I = {}
    for how, r in runs.items():
        out[f'chain_{how}_s'], I[how] = _mc_timed(lambda: intensity(r))
        tk.LAUNCHES.clear()
        _mc_counts(mesh)
        intensity(r)
        torch.cuda.synchronize()
        out[f'chain_{how}_launches'] = dict(tk.LAUNCHES)
        out[f'chain_{how}_bytes'] = _mc_bytes(mesh)
    for how in ('mesh', 'ring'):
        out[f'chain_{how}_err'] = float(np.max(np.abs(
            I[how] - I['single'])) / np.max(I['single']))
        out[f'chain_{how}_equal'] = bool(np.array_equal(I[how],
                                                        I['single']))
    out['chain_peak'] = float(I['single'].max())

    # the toroid -> screen hop on B2, 'fast' and 'exact'
    stages, _ = hop_inputs(run, els)
    oeLocal, wave = stages[1]
    for pm in ('fast', 'exact'):
        hop = {}
        for how, m in (('single', None), ('mesh', mesh)):
            tk.LAUNCHES.clear()
            o = W.diffract(oeLocal, wave, phase_mode=pm, monochromatic=True,
                           accumulate='mxu-fast', narrowband=False, mesh=m)
            hop[how] = (o.Jss + o.Jpp).double().cpu().numpy()
            out[f'b2_{pm}_{how}_launches'] = dict(tk.LAUNCHES)
        out[f'b2_{pm}_err'] = float(np.max(np.abs(
            hop['mesh'] - hop['single'])) / np.max(hop['single']))
        out[f'b2_{pm}_equal'] = bool(np.array_equal(hop['mesh'],
                                                    hop['single']))

    # the trace: run_ray_tracing(mesh=) against the ordered sum of the
    # ranks' unsharded passes with the same generators
    src, tor, scr = trace_beamline(TRACE_NRAYS, f32)

    def run_process(bl, g):
        glo, _ = tor.reflect(src.shine(g))
        return {'screen': scr.expose(glo)}

    lim = trace_plot(128)
    runner.calibrate_limits([lim], run_process(
        None, torch.Generator('cuda').manual_seed(40)))

    def plot():
        p = trace_plot(128)
        for a, b in zip((p.xaxis, p.yaxis, p.caxis),
                        (lim.xaxis, lim.yaxis, lim.caxis)):
            a.limits = list(b.limits)
        return p
    pm_ = plot()
    runner.run_ray_tracing(pm_, repeats=1, run_process=run_process,
                           rng=torch.Generator('cuda').manual_seed(1),
                           mesh=mesh)       # warm-up
    pm_ = plot()
    th.LAUNCHES.clear()
    _mc_counts(mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.run_ray_tracing(
        pm_, repeats=TRACE_REPEATS, run_process=run_process,
        rng=torch.Generator('cuda').manual_seed(MC_TRACE_SEED), mesh=mesh)
    torch.cuda.synchronize()
    out['trace_pass_mesh_s'] = (time.perf_counter() - t0) / TRACE_REPEATS
    out['trace_launches'] = dict(th.LAUNCHES)
    out['trace_bytes'] = _mc_bytes(mesh)
    pr = plot()
    rng = torch.Generator('cuda').manual_seed(MC_TRACE_SEED)
    for _ in range(TRACE_REPEATS):
        hs = [runner.histogram_plot(pr, run_process(None, g))
              for g in par.split_generator(rng, W_)]
        total = hs[0]
        for h in hs[1:]:
            total = {k: (total[k] + h[k]) if k != 'counters' else
                     {c: total[k][c] + h[k][c] for c in total[k]}
                     for k in total}
        runner._accumulate(pr, total)
    a, b = _mc_plot_totals(pm_), _mc_plot_totals(pr)
    out['trace_equal'] = all(np.array_equal(a[k], b[k]) for k in a)
    out['trace_flux'] = float(pm_.intensity)
    out['trace_nRaysAll'] = int(pm_.nRaysAll)
    ps = plot()
    out['trace_pass_single_s'] = _mc_timed(lambda: runner.run_ray_tracing(
        ps, repeats=1, run_process=run_process,
        rng=torch.Generator('cuda').manual_seed(3)), reps=3)[0]

    # the data-parallel pitch gradient (sharded_trace): B4 and B4-bwd
    def dp_step():
        pitch = torch.tensor(TRACE_PITCH, device='cuda', requires_grad=True)

        def reduce_fn(beam, m):
            return m.all_reduce(trace_flux(src, tor, scr, beam,
                                           m.replicate(pitch)))
        loss = par.sharded_trace(
            lambda bl, g: src.shine(g), None, mesh,
            torch.Generator('cuda').manual_seed(MC_DP_SEED), reduce_fn)
        loss.backward()
        return float(loss.detach()), float(pitch.grad)
    out['dp_mesh_s'], _ = _mc_timed(dp_step, reps=1)
    th.LAUNCHES.clear()
    _mc_counts(mesh)
    out['dp_loss'], out['dp_grad'] = dp_step()
    torch.cuda.synchronize()
    out['dp_launches'] = dict(th.LAUNCHES)
    out['dp_bytes'] = _mc_bytes(mesh)
    losses, grads = [], []
    t0 = time.perf_counter()
    for g in par.split_generator(
            torch.Generator('cuda').manual_seed(MC_DP_SEED), W_):
        pitch = torch.tensor(TRACE_PITCH, device='cuda', requires_grad=True)
        flux = trace_flux(src, tor, scr, src.shine(g), pitch)
        gr, = torch.autograd.grad(flux, [pitch])
        losses.append(flux.detach())
        grads.append(gr)
    torch.cuda.synchronize()
    out['dp_single_s'] = (time.perf_counter() - t0) / W_
    lsum, gsum = losses[0], grads[0]
    for lo, gr in zip(losses[1:], grads[1:]):
        lsum, gsum = lsum + lo, gsum + gr
    out['dp_equal'] = float(lsum) == out['dp_loss'] and \
        float(gsum) == out['dp_grad']
    del src, tor, scr

    # phase 9's chain gradient through the sharded chain: B1 and B3 per
    # tile, the sources' cotangents summed over ranks
    ctx = grad_context(run, els)
    grads = {}
    for how in ('single', 'mesh'):
        r = runs[how]

        def step(r=r):
            leaves = grad_leaves(f32)
            val = chain_loss(r, els, ctx, *leaves)
            gs = torch.autograd.grad(val, leaves)
            return [float(val.detach())] + [float(g) for g in gs]
        out[f'grad_{how}_s'], grads[how] = _mc_timed(step, reps=1)
        tk.LAUNCHES.clear()
        _mc_counts(mesh)
        step()
        torch.cuda.synchronize()
        out[f'grad_{how}_launches'] = dict(tk.LAUNCHES)
        out[f'grad_{how}_bytes'] = _mc_bytes(mesh)
    out['grad_single'], out['grad_mesh'] = grads['single'], grads['mesh']
    out['grad_err'] = max(abs(a - b) / abs(b) for a, b in
                          zip(grads['mesh'], grads['single']))
    out['grad_equal'] = grads['mesh'] == grads['single']
    return out


def print_multicard(tag, res):
    """The phase-34 printout of one rank's numbers."""
    def b(d):
        return (f'{d["bytes"]} B in {d["collectives"]} collectives'
                + (f', {d["host_bytes"]} B staged through the host'
                   if d['host_bytes'] else ''))
    print(f'phase {tag} rank {res["rank"]} of {res["world"]} '
          f'({res["backend"]}'
          + (', gloo with CUDA tensors: every collective stages its buffer '
             'through the host, the kernels run on the card'
             if res['host_staged'] else '') + ')', flush=True)
    print(f'phase {tag} chain {MC_NRAYS} samples: unsharded '
          f'{res["chain_single_s"] * 1e3:.1f} ms, destinations split '
          f'{res["chain_mesh_s"] * 1e3:.1f} ms ({b(res["chain_mesh_bytes"])}'
          f'), ring {res["chain_ring_s"] * 1e3:.1f} ms '
          f'({b(res["chain_ring_bytes"])}); against the unsharded '
          f'{res["chain_mesh_err"]:.3e} / {res["chain_ring_err"]:.3e} of the '
          f'peak (bit-identical {res["chain_mesh_equal"]} / '
          f'{res["chain_ring_equal"]}); launches '
          f'{res["chain_mesh_launches"]} / {res["chain_ring_launches"]}',
          flush=True)
    print(f'phase {tag} B2 toroid -> screen hop split: fast '
          f'{res["b2_fast_err"]:.3e}, exact {res["b2_exact_err"]:.3e} of '
          f'the peak; launches {res["b2_fast_mesh_launches"]}, '
          f'{res["b2_exact_mesh_launches"]}', flush=True)
    print(f'phase {tag} trace: {TRACE_NRAYS} rays a rank a pass, '
          f'run_ray_tracing(mesh=) pass {res["trace_pass_mesh_s"] * 1e3:.1f}'
          f' ms against an unsharded pass '
          f'{res["trace_pass_single_s"] * 1e3:.1f} ms '
          f'({b(res["trace_bytes"])}); the ordered sum of the ranks\' '
          f'unsharded passes bit for bit {res["trace_equal"]}; flux '
          f'{res["trace_flux"]:.6g}, nRaysAll {res["trace_nRaysAll"]}; '
          f'launches {res["trace_launches"]}', flush=True)
    print(f'phase {tag} data-parallel pitch gradient (sharded_trace): '
          f'loss {res["dp_loss"]:.6e}, gradient {res["dp_grad"]:.6e}, '
          f'the ordered sums bit for bit {res["dp_equal"]}; step '
          f'{res["dp_mesh_s"] * 1e3:.1f} ms against '
          f'{res["dp_single_s"] * 1e3:.1f} ms a rank unsharded '
          f'({b(res["dp_bytes"])}); launches {res["dp_launches"]}',
          flush=True)
    print(f'phase {tag} chain gradient through the sharded chain: '
          f'{res["grad_mesh"]} against {res["grad_single"]} (max rel '
          f'{res["grad_err"]:.3e}); step {res["grad_mesh_s"] * 1e3:.1f} ms '
          f'against {res["grad_single_s"] * 1e3:.1f} ms '
          f'({b(res["grad_mesh_bytes"])}); launches '
          f'{res["grad_mesh_launches"]}', flush=True)


def check_multicard(tag, res):
    """One rank's numbers of :func:`multicard_paths` held to the limits of
    a world of several ranks: every kernel of the paths launched, the
    chain, the B2 hop and the chain gradient within MC_CHAIN_LIMIT /
    MC_GRAD_LIMIT of their unsharded runs, the trace and the data-parallel
    gradient the ordered sums of the ranks' unsharded ones bit for bit.
    Raises PhaseError."""
    from xrt_tpu_torch import histogram as th
    route = f'hist_plot:{th.plot_route((128,) * 3)}'
    check(res['chain_mesh_launches'].get('kirchhoff_recentred:mono', 0) >= 2
          and res['chain_ring_launches'].get('kirchhoff_recentred:mono', 0)
          >= 2 * res['world'], f'{tag}: B1 on the sharded chain '
          f'{res["chain_mesh_launches"]} {res["chain_ring_launches"]}')
    for pm in ('fast', 'exact'):
        check(res[f'b2_{pm}_mesh_launches'].get(f'kirchhoff_ddphase:{pm}',
                                                0) == 1,
              f'{tag}: B2 {pm} on the sharded hop '
              f'{res[f"b2_{pm}_mesh_launches"]}')
    check(res['trace_launches'].get(route, 0) == TRACE_REPEATS,
          f'{tag}: hist_plot on the sharded pass {res["trace_launches"]}')
    check(res['dp_launches'].get('hist2d:k1:' + th.hist_route(128, 128, 1),
                                 0) == 1 and
          res['dp_launches'].get('hist2d_bwd:k1', 0) == 1,
          f'{tag}: B4 / B4-bwd on the data-parallel step '
          f'{res["dp_launches"]}')
    check(res['grad_mesh_launches'].get('kirchhoff_recentred_bwd:mono', 0)
          >= 1, f'{tag}: B3 on the sharded gradient '
          f'{res["grad_mesh_launches"]}')
    for k in ('chain_mesh_err', 'chain_ring_err', 'b2_fast_err',
              'b2_exact_err'):
        check(res[k] < MC_CHAIN_LIMIT,
              f'{tag}: {k} {res[k]:.3e} >= {MC_CHAIN_LIMIT}')
    check(res['grad_err'] < MC_GRAD_LIMIT,
          f'{tag}: sharded chain gradient {res["grad_err"]:.3e}')
    check(res['trace_equal'] and res['dp_equal'],
          f'{tag}: the sharded pass or the data-parallel gradient is not '
          'the ordered sum of the ranks\' unsharded ones')
    check(res['trace_nRaysAll'] == res['world'] * TRACE_REPEATS *
          TRACE_NRAYS, f'{tag}: nRaysAll {res["trace_nRaysAll"]}')


def _mc_rank(rank, world, init, outdir):
    """One rank of phase 34b: a gloo process group of *world* ranks on
    card 0 (file store *init*); writes its numbers to *outdir*."""
    import torch
    import torch.distributed as dist
    from xrt_tpu_torch import parallel as par
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group('gloo', init_method='file://' + init,
                            rank=rank, world_size=world)
    try:
        mesh = par.make_mesh(device='cuda:0')
        res = multicard_paths(mesh)
        with open(os.path.join(outdir, f'rank{rank}.json'), 'w') as f:
            json.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def phase_multicard(timing):
    """Phase 34: the multi-card layer on the one card: (a) a world of 1
    over NCCL in this process, bit-identical to the unsharded runs; (b) a
    world of 2 processes on the same card over gloo (NCCL refuses two
    ranks on one device), within MC_CHAIN_LIMIT / MC_GRAD_LIMIT and the
    ordered sums bit for bit."""
    import tempfile
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from xrt_tpu_torch import parallel as par
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        store = dist.FileStore(os.path.join(d, 'nccl'), 1)
        dist.init_process_group('nccl', store=store, rank=0, world_size=1,
                                device_id=torch.device('cuda', 0))
        try:
            res = multicard_paths(par.make_mesh(device='cuda:0'))
        finally:
            dist.destroy_process_group()
    print_multicard('34a', res)
    check_multicard('34a', res)
    check(all(res[k] for k in ('chain_mesh_equal', 'chain_ring_equal',
                               'b2_fast_equal', 'b2_exact_equal',
                               'trace_equal', 'dp_equal', 'grad_equal')),
          '34a: a world of 1 is not bit-identical to the unsharded runs: '
          + str({k: v for k, v in res.items() if k.endswith('_equal')}))
    timing['mc1'] = res
    t_a = time.perf_counter() - t_phase

    world = 2
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.start_processes(_mc_rank, args=(world, os.path.join(
            d, 'init'), d), nprocs=world, join=False, start_method='spawn')
        deadline = time.time() + MC_TIMEOUT
        try:
            while not ctx.join(timeout=max(1.0, deadline - time.time())):
                check(time.time() < deadline,
                      f'34b: the gloo world did not finish in {MC_TIMEOUT} s')
        except mp.ProcessRaisedException as e:
            raise PhaseError(f'34b: a rank failed: {e}')
        except mp.ProcessExitedException as e:
            raise PhaseError(f'34b: a rank exited: {e}')
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        ranks = []
        for r in range(world):
            with open(os.path.join(d, f'rank{r}.json')) as f:
                ranks.append(json.load(f))
    for res in ranks:
        print_multicard('34b', res)
        check_multicard('34b', res)
        check(res['host_staged'], '34b: gloo with CUDA tensors is staged')
    same = [k for k in ('chain_mesh_err', 'trace_flux', 'dp_loss', 'dp_grad',
                        'grad_mesh') if ranks[0][k] != ranks[1][k]]
    check(not same, f'34b: the ranks disagree on {same}')
    print(f'phase 34 took {time.perf_counter() - t_phase:.1f} s ({t_a:.1f} '
          f's the NCCL world of 1); on one card the sharded times are the '
          f'cost of the layer (collectives, host staging for gloo, two '
          f'processes sharing the card) and say nothing of scaling across '
          f'cards', flush=True)


QOOK_FILES = (('1crystal.xml', 0.5), ('toroid_focus.xml', 0.5),
              ('testGrating.xml', 0.3), ('lens1.xml', 0.5),
              ('4crystals.xml', 0.5), ('testAlignment.xml', 0.5),
              ('BioXAS_Main.xml', 0.05), ('canted_undulators.xml', 0.5),
              ('mask_tests.xml', 0.5))
QOOK_NRAYS = 1_000_000
CLI_SEED = 7
#: the pitch step (rad) phase 35 sets through the server and takes back
SERVE_DPITCH = 1e-4


def phase_cli(timing):
    """Phase 35: ``python -m xrt_tpu_torch`` on the card in subprocesses
    (info, trace, a Takagi-Taupin calc, codegen and its script, qook,
    serve), the nine Qook projects in this process, and the profiler's
    report against CUDA events."""
    import io
    import re
    import shutil
    import tempfile
    import numpy as np
    import torch
    from xrt_tpu_torch import histogram as th, profiler, runner
    from xrt_tpu_torch.beamline import BeamLine
    from xrt_tpu_torch.qook import load_qook_project
    from xrt_tpu_torch.server import BeamLineClient
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    py = [sys.executable, '-m', 'xrt_tpu_torch']
    qook = os.path.join(root, 'tests', 'data', 'qook')
    d = tempfile.mkdtemp()
    procs = {}
    try:
        layout = os.path.join(d, 'config4.json')
        with open(layout, 'w') as f:
            f.write(timing['layout_json'])
        script = os.path.join(d, 'config4.py')
        r = subprocess.run(py + ['codegen', layout, '-o', script,
                                 '--repeats', '1'], capture_output=True,
                           text=True, timeout=300, env=env, cwd=root)
        check(r.returncode == 0 and os.path.exists(script),
              f'35 codegen: {r.stdout} {r.stderr}')
        cmds = {
            'info': py + ['info', layout],
            'trace': py + ['trace', layout, '--repeats', '3', '--seed',
                           str(CLI_SEED)],
            'calc': py + ['calc', 'rocking', '--material', 'Si', '--hkl',
                          '111', '--E', '9000', '--tc', '0.1', '--R',
                          '2000', '--dtheta=-50:150:201'],
            'script': [sys.executable, script],
            'qook': py + ['qook', os.path.join(qook, 'BioXAS_Main.xml'),
                          '--nrays', str(QOOK_NRAYS), '--repeats', '1'],
            'serve': py + ['serve', layout, '--port', '0']}
        t0 = time.perf_counter()
        logs = {}
        for name, cmd in cmds.items():
            logs[name] = (os.path.join(d, name + '.out'),
                          os.path.join(d, name + '.err'))
            with open(logs[name][0], 'w') as fo, \
                    open(logs[name][1], 'w') as fe:
                procs[name] = subprocess.Popen(
                    cmd, stdout=fo, stderr=fe, text=True, env=env, cwd=d,
                    start_new_session=True)

        def text(name, k=0):
            with open(logs[name][k]) as f:
                return f.read()
        # serve on a port the system picks (its printed address): list,
        # get, acquire (a trace on the card), set the pitch off and back,
        # shutdown
        m = None
        while m is None and procs['serve'].poll() is None and \
                time.perf_counter() - t0 < MC_TIMEOUT:
            time.sleep(0.2)
            m = re.search(r'serving beamline on ([\d.]+):(\d+)',
                          text('serve'))
        check(m is not None, f'35 serve: {text("serve")} '
              f'{text("serve", 1)[-4000:]}')
        cli = BeamLineClient(m.group(1), int(m.group(2)))
        cli.sock.settimeout(MC_TIMEOUT)
        try:
            pvs = cli.list()
            oe = next(n for n, p in pvs.items() if 'pitch' in p and
                      n != 'source' and isinstance(p['pitch'], float))
            p0 = cli.get(f'{oe}:pitch')
            a0 = cli.acquire()
            a1 = cli.set(f'{oe}:pitch', p0 + SERVE_DPITCH)['result']
            p1 = cli.get(f'{oe}:pitch')
            a2 = cli.set(f'{oe}:pitch', p0)['result']
            a3 = cli.acquire()
            bye = cli.request(cmd='shutdown')
        except (ValueError, KeyError, OSError) as e:
            raise PhaseError(f'35 serve: {type(e).__name__}: {e}; the '
                             f'server said {text("serve", 1)[-4000:]}')
        finally:
            cli.close()
        outs = {}
        for name, p in procs.items():
            try:
                p.wait(timeout=max(1.0, MC_TIMEOUT -
                                   (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                raise PhaseError(f'35 {name} did not finish in '
                                 f'{MC_TIMEOUT} s')
            outs[name] = text(name)
            check(p.returncode == 0, f'35 {name} exited {p.returncode}: '
                  f'{outs[name][-2000:]} {text(name, 1)[-4000:]}')
        t_sub = time.perf_counter() - t0
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
        shutil.rmtree(d, ignore_errors=True)
    print(f'phase 35 serve: {len(pvs)} elements listed, {oe}:pitch '
          f'{p0!r}, acquire {a0}; set to {p1!r} and re-traced {a1}; set back '
          f'and re-traced {a2}, acquire {a3}; shutdown {bye}', flush=True)
    check(a0['ngood'] > 0 and abs(p1 - p0 - SERVE_DPITCH) < 1e-3 *
          SERVE_DPITCH and a1 != a0 and
          a2 == a0 and a3 == a0 and bye == {'ok': True},
          f'35 serve: {p0} {p1} {a0} {a1} {a2} {a3} {bye}')
    info = outs['info'].strip().splitlines()
    print(f'phase 35 info: {len(info)} elements; {info[0].strip()} ... '
          f'{info[-1].strip()}', flush=True)
    check(len(info) == len(BeamLine.load_from_json(
        timing['layout_json'], device='cuda').flow), '35 info')
    # trace: the printed numbers against the same seed through the API
    bl = BeamLine.load_from_json(timing['layout_json'], device='cuda')
    g = torch.Generator('cuda').manual_seed(CLI_SEED)
    for _ in range(3):
        beams = bl.propagate_flow(g)
    last = list(beams)[-1]
    img = beams[last]
    good = (img.state == 1).cpu().numpy()
    flux = (img.Jss + img.Jpp).detach().double().cpu().numpy()[good].sum()
    want = f"traced; final beam '{last}': {good.sum()} good rays, " \
        f'flux={flux:.5g}'
    print(f'phase 35 trace --repeats 3: {outs["trace"].splitlines()[0]} '
          f'(the API: {want[len("traced; "):]})', flush=True)
    check(want in outs['trace'], f'35 trace: {outs["trace"]} vs {want}')
    heads = [h for h in outs['calc'].splitlines() if h.startswith('#')]
    rows = np.asarray([[float(v) for v in ln.split(',')] for ln in
                       outs['calc'].splitlines() if ln and ln[0] != '#'])
    print(f'phase 35 calc rocking, Si(111) bent to R = 2000 mm '
          f'(Takagi-Taupin on the card): {heads[0]}; {rows.shape[0]} '
          f'angles, peak |rs|^2 {rows[:, 1].max():.4f}', flush=True)
    check(rows.shape == (201, 3) and np.all(np.isfinite(rows)) and
          0.05 < rows[:, 1].max() <= 1.0, '35 calc rocking')
    fs = re.search(r'flux=([0-9.eE+-]+) nGood=(\d+)', outs['script'])
    print(f'phase 35 codegen: the generated script traced '
          f'{outs["script"].strip()}', flush=True)
    check(fs is not None and float(fs.group(1)) > 0, '35 codegen script')
    qp = re.findall(r"plot '(\w+)': flux=([0-9.eE+-]+) nGood=(\d+)",
                    outs['qook'])
    print(f'phase 35 qook BioXAS_Main.xml at {QOOK_NRAYS} rays through the '
          f'command line: {len(qp)} plots, {qp[:2]} ...; the subprocesses '
          f'took {t_sub:.1f} s together', flush=True)
    check(qp and any(int(n) > 0 for *_, n in qp), '35 qook')

    # the nine projects in this process; each project's plots on its
    # traced pass held to hist_plot_plain (oe_hist_plot_check) after the
    # pass's launches are read
    qook_launches = {}
    for fn, min_good in QOOK_FILES:
        t0 = time.perf_counter()
        prj = load_qook_project(os.path.join(qook, fn), nrays=QOOK_NRAYS)
        t_load = time.perf_counter() - t0
        rng = torch.Generator('cuda').manual_seed(5)
        prj.beamline.propagate_flow(rng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        beams = prj.beamline.propagate_flow(rng)
        torch.cuda.synchronize()
        t_pass = time.perf_counter() - t0
        last = list(beams)[-1]
        n = beams[last].x.shape[0]
        frac = float((beams[last].state == 1).sum()) / n
        plots = prj.plots or []
        for p in plots:     # render nothing: the card's machine may lack
            p.saveName = p.persistentName = None    # matplotlib
        print(f'phase 35 qook {fn}: {len(prj.beamline.flow)} elements, '
              f'loaded in {t_load:.2f} s; a pass of {n} rays '
              f'{t_pass * 1e3:.1f} ms; good rays at {last!r} {frac:.4f} '
              f'(min {min_good}); {len(plots)} plots traced', flush=True)
        check(frac > min_good, f'35 qook {fn}: good {frac} <= {min_good}')
        if not plots:
            continue
        th.LAUNCHES.clear()
        runner.run_ray_tracing(
            plots, repeats=1, beamLine=prj.beamline, rng=rng,
            run_process=lambda b_, g_: b_.propagate_flow(g_))
        torch.cuda.synchronize()
        key = 'qook:' + fn[:-len('.xml')]
        launches = dict(th.LAUNCHES)
        qook_launches[key] = launches
        check(sum(launches.values()) == len(plots),
              f'35 {key}: {len(plots)} plots, hist_plot launches {launches}')
        args = [oe_hist_plot_check(35, f'{key} plot {p.title!r}', p, beams)
                for p in plots]
        timing[key] = dict(launches=launches, plot_args=args[0])
    print(f'phase 35 hist_plot launches of the Qook projects\' plots '
          f'{qook_launches}', flush=True)
    timing['qook_keys'] = tuple(qook_launches)

    # the profiler's report of a verbose run against CUDA events
    src, tor, scr = trace_beamline(TRACE_NRAYS, torch.float32)

    def run_process(bl_, g_):
        glo, _ = tor.reflect(src.shine(g_))
        return {'screen': scr.expose(glo)}
    lim = trace_plot(128)
    runner.calibrate_limits([lim], run_process(
        None, torch.Generator('cuda').manual_seed(50)))
    profiler.reset()
    buf = io.StringIO()
    ev = events(2)
    with contextlib.redirect_stdout(buf):
        ev[0].record()
        runner.run_ray_tracing(lim, repeats=TRACE_REPEATS,
                               run_process=run_process, verbose=True,
                               rng=torch.Generator('cuda').manual_seed(51))
        ev[1].record()
    torch.cuda.synchronize()
    ev_s = ev[0].elapsed_time(ev[1]) * 1e-3
    st = profiler.as_dict()
    stage_s = st['runner.step']['total'] + st['runner.accumulate']['total']
    dev_s = st['runner.step']['device_total']
    rep = buf.getvalue().strip().splitlines()
    print('phase 35 profiler report of a verbose run_ray_tracing '
          f'({TRACE_NRAYS} rays x {TRACE_REPEATS}):', flush=True)
    for ln in rep[-3:]:
        print(f'phase 35   {ln}', flush=True)
    print(f'phase 35 profiler: runner.step + runner.accumulate {stage_s:.4f}'
          f' s (runner.step on the card {dev_s:.4f} s) against CUDA events '
          f'around the run {ev_s:.4f} s: {abs(stage_s / ev_s - 1):.3f} '
          f'(limit 0.1)', flush=True)
    check(st['runner.step']['calls'] == TRACE_REPEATS and
          abs(stage_s / ev_s - 1) < 0.1 and abs(dev_s / ev_s - 1) < 0.1,
          f'35 profiler: {stage_s} / {dev_s} vs {ev_s}')
    print(f'phase 35 took {time.perf_counter() - t_phase:.1f} s',
          flush=True)


# ---------------------------------------------------------------------------
# phase 36: the views and control surfaces (glow, webui, epics)
# ---------------------------------------------------------------------------

#: the pitch values of phase 36's scan player and the step of its writes
VIEWS_SCAN = 5
VIEWS_DPITCH = 2e-4
#: seconds a view subprocess or request of phase 36 may take
VIEWS_TIMEOUT = 300
#: the largest device-to-host copy a view request at 1e7 rays may make:
#: O(maxRays + bins^2) values, not the 40 MB of a float32 column
VIEWS_D2H_LIMIT = 1 << 20
VIEWS_SEED = 36


def d2h_bytes(fn):
    """(fn's result, the bytes of the device-to-host copies the card made
    while it ran) by torch.profiler's memcpy events, read from its Chrome
    trace."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, 'trace.json')
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get('traceEvents', [])
    return out, sum(int(e.get('args', {}).get('bytes', 0)) for e in events
                    if e.get('cat') == 'gpu_memcpy' and
                    'DtoH' in e.get('name', ''))


def http(base, path, body=None):
    """(response body, ms) of one request to a web UI; anything but a 200
    fails the phase."""
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data,
                                 method='GET' if body is None else 'POST')
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=VIEWS_TIMEOUT) as r:
            raw, code = r.read(), r.status
    except urllib.error.HTTPError as e:
        raise PhaseError(f'36 {path}: HTTP {e.code} {e.read()[:2000]!r}')
    except OSError as e:
        raise PhaseError(f'36 {path}: {type(e).__name__}: {e}')
    check(code == 200, f'36 {path}: HTTP {code}')
    return raw, (time.perf_counter() - t0) * 1e3


def http_json(base, path, body=None):
    raw, ms = http(base, path, body)
    return json.loads(raw), ms


def numpy_segments(beams, max_rays):
    """The scene's ray segments as the reference package builds them in
    numpy, from whole host copies of the beams' columns."""
    from xrt_tpu_torch.glow import _energy_color
    import numpy as np
    chain = [(n, {k: getattr(b, k).detach().cpu().numpy()
                  for k in ('x', 'y', 'z', 'E', 'state')})
             for n, b in beams.items() if hasattr(b, 'x') and
             not n.endswith(('_local', '_local1', '_local2'))]
    nrays = chain[0][1]['x'].shape[0]
    idx = np.linspace(0, nrays - 1, min(max_rays, nrays)).astype(int)
    allE = np.concatenate([b['E'][idx] for _, b in chain])
    emin, emax = float(allE.min()), float(allE.max())
    out = []
    for (n1, b1), (n2, b2) in zip(chain[:-1], chain[1:]):
        segs = np.stack([np.stack([b1[k][idx] for k in 'xyz'], -1),
                         np.stack([b2[k][idx] for k in 'xyz'], -1)], 1)
        out.append({'from': n1, 'to': n2,
                    'p': np.round(segs, 4).tolist(),
                    'rgb': np.round(_energy_color(b2['E'][idx], emin, emax),
                                    3).tolist(),
                    'good': (b2['state'][idx] == 1).astype(int).tolist()})
    return out


def numpy_bins(v, lo, hi, bins):
    """np.histogram2d's bin of each value on one axis (-1 outside): the
    edges ``np.linspace(lo, hi, bins + 1)``, the last bin closed."""
    import numpy as np
    edges = np.linspace(lo, hi, bins + 1)
    k = np.searchsorted(edges, v, side='right') - 1
    k[v == edges[-1]] = bins - 1
    k[(v < lo) | (v > hi)] = -1
    return k, edges


def readout_checks(cap):
    """The /api/hist table from ``hist2d_kernel`` (*cap*: its inputs and
    output, recorded on the path) against ``hist2d_plain`` with float64
    sums (1e-5 of the peak, the same non-empty bins) and against
    ``np.histogram2d`` on a host copy: every ray both bin alike but rays
    within 4 ulp (at the scale of the range's limits) of a bin edge,
    which are counted; the numpy table with
    those rays moved to the kernel's bins equals the kernel's to 1e-5 of
    the peak.  Returns (err against plain, rays near an edge)."""
    import numpy as np
    import torch
    from xrt_tpu_torch import histogram as th
    x, y, w, bins, xr, zr, got = cap
    ref = th.hist2d_plain(x, y, w[:, None], bins, bins, xr, zr,
                          sum_dtype=torch.float64)[..., 0]
    peak = float(ref.abs().max())
    err = float((got.double() - ref).abs().max()) / peak
    check(err < 1e-5 and bool(((got != 0) == (ref != 0)).all()),
          f'36 /api/hist table against hist2d_plain: {err}')
    # the kernel's bins (its formula, in the rays' dtype on the card)
    fx, inx = th._bin_index(x, xr, bins)
    fz, inz = th._bin_index(y, zr, bins)
    kx = torch.where(inx, fx, -1).long().cpu().numpy()
    kz = torch.where(inz, fz, -1).long().cpu().numpy()
    xh, zh = x.cpu().numpy(), y.cpu().numpy()
    wh = w.double().cpu().numpy()
    nx, ex = numpy_bins(xh.astype(np.float64), xr[0], xr[1], bins)
    nz, ez = numpy_bins(zh.astype(np.float64), zr[0], zr[1], bins)
    H, _, _ = np.histogram2d(xh, zh, bins=bins, range=[list(xr), list(zr)],
                             weights=wh)
    mism = (kx != nx) | (kz != nz)
    idx = np.nonzero(mism)[0]

    def ulps(v, edges, lim):
        """Distance of *v* from the nearest edge in ulps of the rays'
        dtype at the scale of the value or the range's limits, whichever
        is larger: the kernel subtracts the lower limit in that dtype."""
        d = np.abs(v.astype(np.float64)[:, None] - edges[None, :]).min(1)
        scale = np.maximum(np.abs(v), max(abs(lim[0]), abs(lim[1])))
        return d / np.spacing(scale.astype(v.dtype)).astype(np.float64)
    far = np.minimum(ulps(xh[idx], ex, xr), ulps(zh[idx], ez, zr))
    check((far <= 4).all(), f'36 /api/hist: {int((far > 4).sum())} rays '
          f'bin apart from np.histogram2d farther than 4 ulp from an edge '
          f'(the farthest {far.max(initial=0):.1f} ulp)')
    moved = H.T.copy()
    for i in idx:
        if nx[i] >= 0 and nz[i] >= 0:
            moved[nz[i], nx[i]] -= wh[i]
        if kx[i] >= 0 and kz[i] >= 0:
            moved[kz[i], kx[i]] += wh[i]
    gh = got.double().cpu().numpy()
    nerr = float(np.abs(gh - moved).max()) / peak
    check(nerr < 1e-5, f'36 /api/hist table against np.histogram2d: {nerr}')
    return err, nerr, int(len(idx))


class _FakeRecord:
    """A record of the stand-in softioc: what a client reads and writes."""

    def __init__(self, name, initial_value=None, on_update=None):
        self.name, self.value, self.on_update = name, initial_value, \
            on_update

    def set(self, v):
        self.value = v

    def get(self):
        return self.value

    def caput(self, v):
        self.value = v
        if self.on_update is not None:
            self.on_update(v)


def fake_softioc():
    """A stand-in ``softioc`` module with the builder interface
    ``EpicsIOC`` uses (the IOC library is not installed on the card's
    machine); returns (module, the records it made)."""
    import types
    made = {}

    def rec(record, initial_value=None, on_update=None, **kw):
        made[record] = _FakeRecord(record, initial_value, on_update)
        return made[record]
    builder = types.SimpleNamespace(
        aOut=rec, aIn=rec, boolOut=rec, boolIn=rec, stringIn=rec,
        WaveformIn=rec, SetDeviceName=lambda p: None,
        LoadDatabase=lambda: made.setdefault('~loaded', True))
    mod = types.ModuleType('softioc')
    mod.builder = builder
    mod.softioc = types.SimpleNamespace(iocInit=lambda: None)
    return mod, made


def ioc_readbacks(results):
    """{element: {'flux', 'image'}} of flow outputs: the good rays' flux
    (float64 sum on the card) and a 128 x 128 image by ``hist2d``."""
    import torch
    from xrt_tpu_torch.histogram import hist2d
    out = {}
    for key, val in results.items():
        b = val[0] if isinstance(val, tuple) else val
        if key.startswith('~') or not hasattr(b, 'state'):
            continue
        w = torch.where(b.state == 1, b.Jss + b.Jpp, 0.0)
        out[key.split('.')[0]] = {
            'flux': float(w.sum(dtype=torch.float64)),
            'image': hist2d(b.x, b.z, w, 128, 128, (-2, 2), (-2, 2))}
    return out


def phase_views(timing):
    """Phase 36: the views and control surfaces on the card: the 3D view
    and its scan player, the web UI's requests on phase 6's beamline at
    1e7 rays, ``glow``, ``bob`` and ``serve --ui`` in subprocesses, the
    Phoebus screens of the nine Qook projects and an IOC on a stand-in
    ``softioc`` module."""
    import re
    import shutil
    import tempfile
    import numpy as np
    import torch
    from xrt_tpu_torch import epics, glow, histogram as th
    from xrt_tpu_torch.beamline import BeamLine
    from xrt_tpu_torch.flow import record_flow
    from xrt_tpu_torch.qook import load_qook_project
    from xrt_tpu_torch.webui import WebUI
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    # the profiler's bytes, calibrated on a known copy
    t = torch.ones(1000, device='cuda')
    _, calib = d2h_bytes(lambda: t.cpu())
    measured = calib == 4000
    print(f'phase 36 torch.profiler memcpy bytes of a 4000-byte copy: '
          f'{calib}' + ('' if measured else ' (device-to-host bytes not '
                        'measured below)'), flush=True)

    def d2h(fn):
        out, n = d2h_bytes(fn)
        return out, (n if measured else None)

    th.LAUNCHES.clear()
    src, tor, scr = trace_beamline(TRACE_NRAYS, torch.float32)
    bl = BeamLine(alignE=9000.0, name='trace benchmark')
    bl.add('source', src)
    bl.add('mirror', tor)
    bl.add('screen', scr)
    with record_flow(bl) as flow:
        beams = bl.propagate_flow(torch.Generator('cuda').manual_seed(
            VIEWS_SEED))
    torch.cuda.synchronize()

    # (a) glow: a scene of the traced beams, the HTML file, the scan player
    d = tempfile.mkdtemp()
    procs = {}
    try:
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            scene = glow.build_scene(bl, beams=beams)
            ms.append((time.perf_counter() - t0) * 1e3)
        _, nb = d2h(lambda: glow.build_scene(bl, beams=beams))
        want = numpy_segments(beams, 200)
        check(scene['segments'] == want, '36 glow: the segments differ '
              'from numpy on whole host copies of the beams')
        html = bl.glow(beams=beams, save=os.path.join(d, 'glow.html'))
        size = os.path.getsize(html)
        print(f'phase 36 glow: a scene of {TRACE_NRAYS} rays x 3 beams '
              f'({len(scene["elements"])} elements, '
              f'{len(scene["segments"])} x 200 segments) '
              f'{statistics.median(ms):.1f} ms (median of 3), '
              f'device-to-host {nb} bytes; segments equal numpy\'s on whole '
              f'host copies; HTML {size} bytes', flush=True)
        pitches = [TRACE_PITCH + k * VIEWS_DPITCH for k in range(VIEWS_SCAN)]
        t0 = time.perf_counter()
        out = bl.glow(scan={'element': 'mirror', 'param': 'pitch',
                            'values': pitches}, flow=flow,
                      save=os.path.join(d, 'scan.html'))
        t_scan = (time.perf_counter() - t0) * 1e3
        text = open(out).read()
        scenes = json.loads(text.split('const SCENES = ')[1].split(';\n')[0])
        zs = [float(np.mean([p[1][2] for p in [
            s for s in sc['segments'] if s['to'].startswith('screen')][0][
                'p']])) for sc in scenes]
        print(f'phase 36 glow scan of mirror.pitch over {VIEWS_SCAN} values: '
              f'{t_scan / VIEWS_SCAN:.1f} ms a frame (a replay from the '
              f'mirror at {TRACE_NRAYS} rays and a scene); mean end z of '
              f'the post-mirror segments {[round(z, 4) for z in zs]} mm',
              flush=True)
        check(len(scenes) == VIEWS_SCAN and
              all(b > a for a, b in zip(zs, zs[1:])) and zs[-1] - zs[0] > 1,
              f'36 glow scan: z {zs}')

        # (b) the web UI on the same beamline and flow
        ui = WebUI(bl, flow).start()
        base = f'http://{ui.host}:{ui.port}'
        try:
            cap = []
            orig = th.hist2d

            def recorded(x, y, w, xb, yb, xl, yl):
                out = orig(x, y, w, xb, yb, xl, yl)
                cap.append((x, y, w, xb, tuple(xl), tuple(yl), out))
                return out
            th.hist2d = recorded
            try:
                hist0, _ = http_json(base, '/api/hist')
            finally:
                th.hist2d = orig
            check(len(cap) == 1 and hist0['nGood'] > 0,
                  f'36 /api/hist: {len(cap)} tables, {hist0.get("nGood")}')
            err, nerr, nedge = readout_checks(cap[0])
            timing['views_hist_args'] = cap[0][:6]
            print(f'phase 36 /api/hist table ({cap[0][0].shape[0]} good '
                  f'rays into {cap[0][3]} x {cap[0][3]} by hist2d_kernel): '
                  f'against hist2d_plain (float64 sums) {err:.2e} of the '
                  f'peak, against np.histogram2d {nerr:.2e} with {nedge} '
                  f'rays within 4 ulp of an edge binned apart', flush=True)
            rows = []
            reqs = [('/', None), ('/api/elements', None), ('/api/hist', None),
                    ('/api/probe?d=-500', None), ('/api/probe?d=0', None),
                    ('/api/probe?d=500', None),
                    ('/api/inspect?element=mirror', None),
                    ('/api/scene', None)]
            for path, body in reqs:
                ms = [http(base, path, body)[1] for _ in range(3)]
                _, nb = d2h(lambda: http(base, path, body))
                rows.append((path, statistics.median(ms), nb))
            probes = [http_json(base, f'/api/probe?d={v}')[0]
                      for v in (-500, 0, 500)]
            check(all(p['nGood'] > 0 for p in probes),
                  f'36 /api/probe: {[p.get("nGood") for p in probes]}')
            ins = http_json(base, '/api/inspect?element=mirror')[0]
            check(ins['footprint']['nGood'] > 0 and
                  0 < ins['transmission'] <= 1, f'36 inspect: {ins}')
            sc = http_json(base, '/api/scene')[0]
            check(sc['segments'] and {'source', 'mirror', 'screen'} <=
                  {e['name'] for e in sc['elements']}, '36 /api/scene')
            # three writes of the pitch: the focus moves by 2 dpitch q
            ms, czs = [], [hist0['cz']]
            for k in (1, 2, 0):
                r, t_ = http_json(base, '/api/set', {
                    'element': 'mirror', 'param': 'pitch',
                    'value': TRACE_PITCH + k * VIEWS_DPITCH})
                check(r.get('ok'), f'36 /api/set: {r}')
                ms.append(t_)
                czs.append(http_json(base, '/api/hist')[0]['cz'])
            _, nb = d2h(lambda: http(base, '/api/set', {
                'element': 'mirror', 'param': 'pitch',
                'value': TRACE_PITCH}))
            rows.append(('/api/set', statistics.median(ms), nb))
            step = 2 * VIEWS_DPITCH * TRACE_Q
            moves = [b - a for a, b in zip(czs, czs[1:])]
            print(f'phase 36 /api/set of the pitch +{VIEWS_DPITCH}, '
                  f'+{2 * VIEWS_DPITCH}, back: the focus centroid z '
                  f'{[round(c, 5) for c in czs]} mm (steps {moves}, '
                  f'expected {step}, {step}, {-2 * step})', flush=True)
            check(abs(moves[0] / step - 1) < 0.15 and
                  abs(moves[1] / step - 1) < 0.15 and
                  abs(czs[3] - czs[0]) < 1e-6, f'36 /api/set: {czs}')
        finally:
            ui.stop()
        for path, m, nb in rows:
            print(f'phase 36 request {path}: {m:.2f} ms (median of 3), '
                  f'device-to-host {nb} bytes', flush=True)
            check(nb is None or nb < VIEWS_D2H_LIMIT,
                  f'36 {path} copied {nb} bytes to the host')
        timing['views_rows'] = rows

        # (c) the command line: serve --ui with phase 33's layout and
        # without one (assembly), glow and bob, all at once
        env = dict(os.environ, PYTHONPATH=root)
        py = [sys.executable, '-m', 'xrt_tpu_torch']
        layout = os.path.join(d, 'config4.json')
        with open(layout, 'w') as f:
            f.write(timing['layout_json'])
        nrays = json.loads(timing['layout_json'])['elements'][0][
            'params'].get('nrays')
        cmds = {'ui': py + ['serve', layout, '--ui', '--port', '0'],
                'asm': py + ['serve', '--ui', '--port', '0'],
                'glow': py + ['glow', layout, '--save',
                              os.path.join(d, 'c4.html')],
                'bob': py + ['bob', layout, '--out', os.path.join(d, 'bob')]}
        logs = {}
        t0 = time.perf_counter()
        for name, cmd in cmds.items():
            logs[name] = os.path.join(d, name + '.log')
            with open(logs[name], 'w') as fo:
                procs[name] = subprocess.Popen(
                    cmd, stdout=fo, stderr=subprocess.STDOUT, text=True,
                    env=env, cwd=d, start_new_session=True)

        def log(name):
            with open(logs[name]) as f:
                return f.read()

        def address(name):
            m = None
            while m is None and procs[name].poll() is None and \
                    time.perf_counter() - t0 < VIEWS_TIMEOUT:
                time.sleep(0.2)
                m = re.search(r'beamline UI on (http://[\d.]+:\d+)/',
                              log(name))
            check(m is not None, f'36 serve --ui ({name}): '
                  f'{log(name)[-4000:]}')
            return m.group(1)
        ub = address('ui')
        t_up = time.perf_counter() - t0
        h0, t_h = http_json(ub, '/api/hist')
        els = http_json(ub, '/api/elements')[0]
        oe = next(n for n, p in els.items() if isinstance(
            p.get('pitch'), float) and n != list(els)[0])
        r, t_s = http_json(ub, '/api/set', {
            'element': oe, 'param': 'pitch',
            'value': els[oe]['pitch'] + 1e-5})
        h1 = http_json(ub, '/api/hist')[0]
        print(f'phase 36 serve --ui with phase 33\'s configuration-4 '
              f'layout ({nrays} rays): up in {t_up:.1f} s, /api/hist '
              f'{t_h:.1f} ms ({h0["nGood"]} good rays, cz {h0["cz"]:.6g}), '
              f'/api/set {oe}.pitch +1e-5 {t_s:.1f} ms (cz '
              f'{h1["cz"]:.6g})', flush=True)
        check(r.get('ok') and h0['nGood'] > 0 and h1['nGood'] > 0 and
              h1 != h0, '36 serve --ui with a layout')
        ab = address('asm')
        reg = http_json(ab, '/api/registry')[0]['classes']
        check({'GeometricSource', 'ToroidMirror', 'Screen'} <= set(reg),
              '36 /api/registry')
        p, q = TRACE_P, TRACE_Q
        adds = [
            {'name': 'src', 'class': 'GeometricSource',
             'params': {'nrays': 1_000_000, 'dx': 0.1, 'dz': 0.05,
                        'dxprime': 3e-5, 'dzprime': 3e-5,
                        'distE': 'flat', 'energies': [8900.0, 9100.0]}},
            {'name': 'm1', 'class': 'ToroidMirror', 'distance': p,
             'pitch': TRACE_PITCH,
             'material': {'catalog': 'elemental', 'name': 'Rh'},
             'params': {'R': 2 * p * q / (p + q) / math.sin(TRACE_PITCH),
                        'r': 2 * p * q / (p + q) * math.sin(TRACE_PITCH),
                        'limPhysX': [-20, 20], 'limPhysY': [-300, 300]}},
            {'name': 'scr', 'class': 'Screen', 'distance': q}]
        t_add = []
        for a in adds:
            r, t_ = http_json(ab, '/api/add', a)
            check(r.get('ok'), f'36 /api/add {a["name"]}: {r}')
            t_add.append(t_)
        hs = http_json(ab, '/api/hist?beam=scr')[0]
        r = http_json(ab, '/api/reorder', {'order': ['src', 'm1', 'scr']})[0]
        check(r.get('order') == ['src', 'm1', 'scr'], f'36 reorder: {r}')
        r = http_json(ab, '/api/remove', {'name': 'scr'})[0]
        check(r.get('elements') == ['src', 'm1'], f'36 remove: {r}')
        text_layout = http(ab, '/api/layout')[0].decode()
        r = http_json(ab, '/api/load', {'json': text_layout})[0]
        check(r.get('elements') == ['src', 'm1'], f'36 load: {r}')
        code = http(ab, '/api/codegen')[0].decode()
        print(f'phase 36 serve --ui assembly: registry of {len(reg)} '
              f'classes; GeometricSource (1e6 rays), ToroidMirror, Screen '
              f'added in {[round(t_, 1) for t_ in t_add]} ms, the screen '
              f'{hs["nGood"]} good rays; reorder, remove, layout -> load '
              f'round trip ({len(text_layout)} bytes), codegen '
              f'{len(code)} bytes', flush=True)
        check(hs['nGood'] > 0 and 'ToroidMirror' in code,
              '36 assembly session')
        for name in ('ui', 'asm'):
            os.killpg(procs[name].pid, 9)
            procs[name].wait()
        for name in ('glow', 'bob'):
            try:
                procs[name].wait(timeout=max(1.0, VIEWS_TIMEOUT -
                                             (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                raise PhaseError(f'36 {name} did not finish in '
                                 f'{VIEWS_TIMEOUT} s')
            check(procs[name].returncode == 0,
                  f'36 {name} exited {procs[name].returncode}: '
                  f'{log(name)[-4000:]}')
        nfiles = sum(len(fs) for _, _, fs in os.walk(os.path.join(d,
                                                                  'bob')))
        hsize = os.path.getsize(os.path.join(d, 'c4.html'))
        print(f'phase 36 glow {os.path.basename(layout)}: {hsize} bytes of '
              f'HTML; bob: {nfiles} screens; the subprocesses took '
              f'{time.perf_counter() - t0:.1f} s together', flush=True)
        check(nfiles == len(json.loads(timing['layout_json'])['elements'])
              + 1 and hsize > 1000, '36 glow / bob')
    finally:
        for pr in procs.values():
            if pr.poll() is None:
                os.killpg(pr.pid, 9)
                pr.wait()

    # (d) the PV layer: the Qook projects' screens, an IOC on a stand-in
    try:
        qook = os.path.join(root, 'tests', 'data', 'qook')
        counts = []
        for fn, _ in QOOK_FILES:
            prj = load_qook_project(os.path.join(qook, fn),
                                    nrays=QOOK_NRAYS)
            files = epics.generate_bob_screens(
                prj.beamline, os.path.join(d, 'qook', fn))
            npv = sum(len(s.pvs) for s in epics.iter_element_specs(
                prj.beamline))
            check(len(files) == len(prj.beamline._elements) + 1,
                  f'36 bob {fn}: {len(files)} screens')
            counts.append((fn, len(files), npv))
        print(f'phase 36 bob screens of the nine Qook projects (file, '
              f'screens, PVs): {counts}', flush=True)
        mod, made = fake_softioc()
        sys.modules['softioc'] = mod
        sys.modules['softioc.builder'] = mod.builder
        recorded = dict(bl._elements)
        traces = []

        def trace_fn(bl_):
            changed = {n: el for n, el in bl_._elements.items()
                       if el is not recorded[n]}
            t0 = time.perf_counter()
            out = ioc_readbacks(flow.replay(replace=changed))
            traces.append((time.perf_counter() - t0) * 1e3)
            return out
        try:
            ioc = epics.EpicsIOC(bl, prefix='XRT:', trace_fn=trace_fn)
        finally:
            sys.modules.pop('softioc', None)
            sys.modules.pop('softioc.builder', None)
        ioc.records['AutoUpdate'].set(True)
        errs = []
        for k in (1, 2, 0):
            ioc.records['mirror:pitch'].caput(TRACE_PITCH + k *
                                              VIEWS_DPITCH)
            fresh = BeamLine()
            for name, kind, method, kw in bl.flow:
                fresh.add(name, bl[name], kind, method, **kw)
            full = ioc_readbacks(fresh.propagate_flow(
                torch.Generator('cuda').manual_seed(VIEWS_SEED)))
            got = ioc.records['screen:flux'].get()
            errs.append(abs(got / full['screen']['flux'] - 1))
            img = ioc.records['screen:image'].get()
            check(img.size == 128 * 128 and img.sum() > 0 and
                  np.array_equal(img, full['screen']['image'].cpu().numpy(
                  ).ravel()), f'36 IOC image after pitch write {k}')
        print(f'phase 36 EpicsIOC on a stand-in softioc: '
              f'{len(ioc.records)} records; three writes of mirror:pitch, '
              f'each a replay from the mirror ({[round(t_, 1) for t_ in traces]}'
              f' ms); screen flux against a full re-trace {errs} (limit '
              f'1e-9), images bit-identical', flush=True)
        check(len(traces) == 3 and max(errs) < 1e-9, f'36 IOC: {errs}')
    finally:
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.synchronize()
    timing['views_launches'] = dict(th.LAUNCHES)
    print(f'phase 36 kernel launches of the views: '
          f'{timing["views_launches"]}; the phase took '
          f'{time.perf_counter() - t_phase:.1f} s', flush=True)
    check(sum(v for k, v in th.LAUNCHES.items()
              if k.startswith('hist2d:k1')) > 0,
          '36: hist2d_kernel was not launched on the views\' path')


def views_main(layout, out):
    """``chip_smoke.py --views LAYOUT OUT``: phase 36 on the JSON layout
    LAYOUT (phase 33's) in this process, its kernels row written to OUT
    as JSON; non-zero if a check fails."""
    with open(layout) as f:
        timing = {'layout_json': f.read()}
    try:
        phase_views(timing)
        rows = views_rows(timing)
    except PhaseError as e:
        print(f'chip_smoke --views: FAILED: {e}', file=sys.stderr)
        return 1
    with open(out, 'w') as f:
        json.dump(rows, f)
    return 0


def phase_views_process(timing):
    """Phase 36 in a fresh process of this script (``--views``): once this
    process has spawned phase 34b's ranks, torch.profiler here no longer
    sees its copies to pageable host memory (a 4000-byte ``.cpu()`` leaves
    no memcpy event; a fresh process sees it), and phase 36 counts bytes
    by those events.  The child sets and reads the launch counts of its
    own path; its lines print here, its kernels row comes back as JSON;
    it is killed with everything it started if it outlives its time."""
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        layout, out = os.path.join(d, 'layout.json'), os.path.join(d, 'row')
        with open(layout, 'w') as f:
            f.write(timing['layout_json'])
        sys.stdout.flush()
        proc = subprocess.Popen([sys.executable, os.path.join(
            root, 'chip_smoke.py'), '--views', layout, out], cwd=root,
            start_new_session=True)
        try:
            rc = proc.wait(timeout=3 * VIEWS_TIMEOUT)
        except subprocess.TimeoutExpired:
            raise PhaseError(f'36 did not finish in {3 * VIEWS_TIMEOUT} s')
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
        check(rc == 0 and os.path.exists(out), f'36 exited {rc}')
        with open(out) as f:
            timing['views_rows_line'] = json.load(f)


def views_rows(timing):
    """The kernels line's row of phase 36: ``hist2d_kernel`` at the
    /api/hist table's shape (the good rays of the 1e7-ray image into
    80 x 80), its launches on the views' path (every /api/hist and
    /api/probe: the table and two 128-bin widths; the IOC's images)."""
    import torch
    from xrt_tpu_torch import histogram as th
    x, y, w, bins, xr, zr = timing['views_hist_args']
    args = (x, y, w[:, None], bins, bins, xr, zr)
    route = th.hist_route(bins, bins, 1)
    kernel = lambda: th.hist2d_kernel(*args)
    kernel()
    torch.cuda.synchronize()
    ms = statistics.median(cuda_ms(kernel, 20)[0] for _ in range(3))
    got = kernel()
    plain_ms, _ = cuda_ms(lambda: th.hist2d_plain(*args))
    ref = th.hist2d_plain(*args, sum_dtype=torch.float64)
    rel, ab, _ = hist_errors(got, ref)
    fx, inx = th._bin_index(x, xr, bins)
    fy, iny = th._bin_index(y, zr, bins)
    inside = inx & iny
    flat = torch.where(inside, fy * bins + fx, torch.zeros_like(fx)).long()
    wi = torch.where(inside[:, None], args[2], torch.zeros_like(args[2]))
    library = lambda: torch.zeros((bins * bins, 1), device='cuda',
                                  dtype=wi.dtype).index_add_(0, flat, wi)
    library()
    lib_ms = statistics.median(cuda_ms(library, 20)[0] for _ in range(3))
    n = x.shape[0]
    bms = 1e3 * (4.0 * n * 3 + 4.0 * bins * bins) / PEAK_BYTES
    launches = sum(v for k, v in timing['views_launches'].items()
                   if k.startswith('hist2d:k1'))
    print(f'phase 5 hist2d:views: {n} rays into {bins} x {bins} ({route}), '
          f'kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, index_add_ '
          f'{lib_ms:.4f} ms, bound {bms:.4f} ms (bytes), launches '
          f'{launches} (phase 36)', flush=True)
    check(launches > 0, 'hist2d:views was not launched on its path')
    return [dict(name='hist2d:views', route='cuda', source=SOURCES['hist2d'],
                 replaces=REPLACES['hist2d'], launches=launches,
                 max_abs_err=ab, max_rel_err=rel, ms=ms, plain_ms=plain_ms,
                 bound_ms=bms, bound_by='bytes', library_ms=lib_ms)]


#: the ray paths of phases 21-25 and 27-29, by their keys in ``timing``
OE_HIST_KEYS = ('laue', 'crl', 'multilayer', 'powder', 'fe:waviness',
                'fe:roughness', 'fe:bump', 'capillary', 'mesh:quad',
                'mesh:spline', 'txm')


#: the ray paths of phases 30-33
SLICE_HIST_KEYS = ('config3:near', 'config3:far', 'config3:taper',
                   'config4:search', 'customfield', 'catalog:Ge')


def oe_physics_rows(timing, keys=OE_HIST_KEYS):
    """``hist_plot``'s rows on the paths of *keys* (phases 21-25 and
    27-29 by default; phases 30-33 and the Qook projects of phase 35 are
    the other calls)."""
    import torch
    from xrt_tpu_torch import histogram as th
    rows = []
    for key in keys:
        args = timing[key]['plot_args']
        bins = args[6]
        route = th.plot_route(bins)
        kernel = lambda: th.hist_plot_kernel(*args)  # noqa: E731
        kernel()
        torch.cuda.synchronize()
        ms = statistics.median(cuda_ms(kernel, 5)[0] for _ in range(3))
        got = kernel()
        plain_ms, _ = cuda_ms(lambda: th.hist_plot_plain(*args))
        ref = th.hist_plot_plain(*args, sum_dtype=torch.float64)
        rel, _ = plot_errors(got, ref)
        ab = max(float((got[k].double() - ref[k]).abs().max())
                 for k in th.PLOT_HISTS)
        n = args[0].shape[0]
        bx, by, bc = bins
        bms = 1e3 * (21.0 * n + 4.0 * (4 * (bx + by + bc + bx * by) + 1)) / \
            PEAK_BYTES
        launches = int(timing[key]['launches'].get(f'hist_plot:{route}', 0))
        print(f'phase 5 hist_plot:{key}: {n} rays of a pass into eight '
              f'histograms ({route}), kernel {ms:.4f} ms, plain '
              f'{plain_ms:.2f} ms, bound {bms:.4f} ms (bytes), launches '
              f'{launches}', flush=True)
        rows.append(dict(name=f'hist_plot:{key}', route='cuda',
                         source=SOURCES['hist_plot'],
                         replaces=REPLACES['hist_plot'], launches=launches,
                         max_abs_err=ab, max_rel_err=rel, ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, bound_by='bytes',
                         library_ms=None))
        check(launches > 0, f'hist_plot:{key} was not launched on its path')
        check(rel < 1e-5, f'hist_plot:{key}: {rel:.3e}')
    return rows


def main():
    try:
        import torch
    except ImportError:
        print('chip_smoke: torch is not installed', file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    try:
        import xrt_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f'chip_smoke: run from a checkout of the repository ({e})',
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == ['--sweep-plain-blocks']:
        phase_card()
        sweep_plain_blocks()
        return 0
    if sys.argv[1:2] == ['--views']:
        return views_main(*sys.argv[2:4])
    t_all = time.perf_counter()
    timing = {}
    try:
        card = phase_card()
        phase_kernels()
        phase_hist_kernel()
        phase_main(timing)
        phase_cross(timing)
        phase_trace(timing)
        phase_trace_cross()
        phase_adjoint_kernels(timing)
        phase_grad_main(timing)
        phase_grad_cross()
        phase_grad_b2(timing)
        phase_trace_grad(timing)
        phase_softimax(timing)
        phase_softimax_cross()
        phase_prep_kernel(timing)
        phase_analyzer(timing)
        phase_toroid_search(timing)
        phase_dcm(timing)
        phase_config4(timing)
        phase_coherent_modes(timing)
        phase_config2(timing)
        phase_field_maps()
        phase_tt(timing)
        phase_crl(timing)
        phase_multilayer(timing)
        phase_powder(timing)
        phase_figure_errors(timing)
        phase_fe_wave(timing)
        phase_capillary(timing)
        phase_mesh(timing)
        phase_txm(timing)
        phase_config3(timing)
        phase_search(timing)
        phase_customfield(timing)
        phase_layouts(timing)
        phase_multicard(timing)
        phase_cli(timing)
        phase_views_process(timing)
        rows = phase_kernel_line(timing) + hist_rows(timing) + \
            crystal_hist_rows(timing) + adjoint_rows(timing) + \
            timing['softimax_rows'] + prep_rows(timing) + \
            coherence_rows(timing) + \
            oe_physics_rows(timing) + fe_wave_rows(timing) + \
            oe_physics_rows(timing, SLICE_HIST_KEYS) + \
            oe_physics_rows(timing, timing['qook_keys']) + \
            timing['views_rows_line']
    except PhaseError as e:
        print(f'chip_smoke: FAILED: {e}', file=sys.stderr)
        return 1
    print(f'total {time.perf_counter() - t_all:.1f} s')
    print(card)
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
