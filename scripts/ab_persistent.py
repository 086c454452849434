#!/usr/bin/env python3
"""Time this checkout's persistent megakernel against another checkout's,
in one process on one NVIDIA card.

    python3 scripts/ab_persistent.py --parent DIR

DIR holds the other checkout of the repo (for example `git archive
<commit> | tar -x -C DIR`, into a directory that .gitignore lists). Both
packages build csrc/megakernel.cu at once, each into its own
build/kernels/. Then, on the Cornell box at 2048 spp and on chip_smoke's
lights-and-composites scene at 256 spp (256², 8 bounces, seed 0), each
package builds its own scene and tables and launches its own
run_persistent; the script fails unless the two give the same output
rows bit for bit, and prints each launch's time by CUDA events in the
turns P N N P N P (P the other checkout, N this one), with the card's
name and power limit.
"""
import argparse
import concurrent.futures
import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

RES, DEPTH, RR_DEPTH = 256, 8, 5
TURNS = "PNNPNP"


def load_package(checkout: Path, name: str):
    """The checkout's mitsuba_tpu_torch, imported as `name`."""
    init = checkout / "mitsuba_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return pkg


def submodules(name):
    """The modules of package `name` that the scenes and launches use."""
    mod = lambda sub: importlib.import_module(f"{name}.{sub}")
    return {k: mod(v) for k, v in (
        ("mk", "accel.megakernel"), ("mega", "integrator.mega"),
        ("path", "integrator.path"), ("builder", "scene.builder"),
        ("presets", "scene.presets"), ("shapes", "scene.shapes"),
        ("tf", "core.transform"), ("sensor", "sensor.sensor"))}


def scene_launch(m, scene_name, spp):
    """A no-argument launch of package m's run_persistent on its own
    build of the scene."""
    if scene_name == "cornell":
        scene = m["builder"].compile_scene(m["presets"].cornell_box(),
                                           device="cuda")
        cam = m["presets"].cornell_camera(RES, RES)
    else:
        desc = cs.lights_composites_desc(m["builder"], m["tf"], m["shapes"])
        scene = m["builder"].compile_scene(desc, device="cuda")
        cam = cs.leaf_families_camera(m["sensor"].PerspectiveCamera, m["tf"],
                                      RES)
    tables = m["mega"].MegaPathTracer.for_scene(scene,
                                                max_depth=DEPTH).tables
    pix = torch.arange(RES * RES, dtype=torch.int32, device="cuda")
    samp = torch.zeros_like(pix)
    st0 = m["path"].initial_state(*m["mk"].primary_rays(cam, 0, pix, 0))
    state = torch.cat([st0, torch.zeros_like(st0[:8])])
    return lambda: m["mk"].run_persistent(tables, RR_DEPTH, DEPTH, spp, cam,
                                          state, pix, samp, 0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="the other checkout of the repo")
    args = ap.parse_args()
    cs.check(torch.cuda.is_available(), "no CUDA device")
    card = cs.card_line()
    pkgs = {"P": submodules(load_package(args.parent.resolve(),
                                         "ab_parent").__name__),
            "N": submodules("mitsuba_tpu_torch")}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for tag, (lib, _) in zip(pkgs, pool.map(lambda m: m["mk"].build(),
                                                pkgs.values())):
            print(f"[ab] {tag} built {lib}", flush=True)
    for scene_name, spp in (("cornell", 2048), ("lights", 256)):
        runs = {tag: scene_launch(m, scene_name, spp)
                for tag, m in pkgs.items()}
        outs = {tag: run() for tag, run in runs.items()}
        cs.check(torch.equal(outs["P"], outs["N"]),
                 f"{scene_name}: the two builds' rows differ")
        print(f"[ab] {scene_name} {spp} spp: rows bit-equal", flush=True)
        for tag in TURNS:
            ms, _ = cs.events_ms(runs[tag])
            print(f"[ab] {scene_name} {spp} spp {tag}: {ms:.4f} ms ({card})",
                  flush=True)


if __name__ == "__main__":
    main()
