#!/bin/bash
# Production NLTE comparison to convergence + science artifacts
# (round-4 verdict ask #2): voronoi 442,368 sites vs regular grid on
# the SAME 192x128x128 synthetic atmosphere, eps=1e-3, maxiter=150,
# checkpoint every iteration, then the regular-vs-voronoi Ly-alpha
# figure suite (multi-mu profiles, centre/wing/continuum images,
# brightness temperature, convergence histories).
set -e
cd "$(dirname "$0")/.."

python drivers/line_nlte.py --grid voronoi --n-sites 442368 \
    --atmos 192 128 128 --f32 --lambda-chunk 91 \
    --voronoi-order wavefront \
    --out artifacts/run_voronoi_442k.h5 2>&1 \
    | tee artifacts/run_voronoi_442k.log

python drivers/line_nlte.py --grid regular \
    --atmos 192 128 128 --f32 --lambda-chunk 16 \
    --out artifacts/run_regular_192.h5 2>&1 \
    | tee artifacts/run_regular_192.log

# figures on CPU float64 (synthesis is a single formal solve per mu,
# fine on the host)
VRT_PLATFORM=cpu python analysis/line_figures.py \
    artifacts/run_regular_192.h5 artifacts/run_voronoi_442k.h5 \
    --out artifacts/line_figures --raster 192 128 128 \
    --mus 1.0 0.6 0.2 2>&1 | tee artifacts/line_figures.log

# deep-NLTE pair: the reference's BOOST=2e9 drives eps -> ~1 and the
# compat iteration converges in ~3 steps; boost=1e5 (eps ~ 0.3) gives a
# physically interesting multi-decade convergence history at the same
# scale (committed as the convergence-figure source)
python drivers/line_nlte.py --grid voronoi --n-sites 442368 \
    --atmos 192 128 128 --f32 --lambda-chunk 91 \
    --voronoi-order wavefront --boost 1e5 \
    --out artifacts/run_voronoi_442k_deep.h5 2>&1 \
    | tee artifacts/run_voronoi_442k_deep.log

python drivers/line_nlte.py --grid regular \
    --atmos 192 128 128 --f32 --lambda-chunk 16 --boost 1e5 \
    --out artifacts/run_regular_192_deep.h5 2>&1 \
    | tee artifacts/run_regular_192_deep.log

VRT_PLATFORM=cpu python analysis/line_figures.py \
    artifacts/run_regular_192_deep.h5 artifacts/run_voronoi_442k_deep.h5 \
    --out artifacts/line_figures_deep --raster 192 128 128 \
    --mus 1.0 0.6 0.2 2>&1 | tee artifacts/line_figures_deep.log
