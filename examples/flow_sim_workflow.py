"""The FlowSim external-binary workflow, runnable WITHOUT gmsh/flow123d.

Demonstrates the full production pattern of the reference's flagship
simulation (groundwater flow): per-level mesh building, solver-input
templating, joint fine/coarse conductivity draws, flux extraction — driven
here by two small mock executables so the example runs anywhere. Point
``env`` at real ``gmsh`` / ``flow123d`` binaries (and a real .geo geometry
+ YAML template) to run the actual solver chain.

Run: python examples/flow_sim_workflow.py
"""
import os

# host-side simulation: keep the per-sample field draws on the CPU jax
# backend (a device round trip per draw would dominate)
os.environ["JAX_PLATFORMS"] = "cpu"

import stat  # noqa: E402
import tempfile  # noqa: E402
import textwrap  # noqa: E402

import numpy as np  # noqa: E402

from mlmc_tpu import FlowSim, Memory, Sampler, ThreadPool, Legendre
from mlmc_tpu import estimator as est_mod
from mlmc_tpu.quantity.quantity import make_root_quantity

MOCK_GMSH = textwrap.dedent('''\
    #!/usr/bin/env python3
    """Mock gmsh: canned unit-square msh2; finer clscale => more triangles."""
    import sys
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    cl = float(args[args.index("-clscale") + 1])
    header = ("$MeshFormat\\n2.2 0 8\\n$EndMeshFormat\\n$PhysicalNames\\n2\\n"
              '2 1 "ground"\\n1 2 ".bc_outflow"\\n$EndPhysicalNames\\n')
    if cl <= 0.3:
        body = ("$Nodes\\n5\\n1 0 0 0\\n2 1 0 0\\n3 1 1 0\\n4 0 1 0\\n"
                "5 0.5 0.5 0\\n$EndNodes\\n$Elements\\n5\\n"
                "1 2 2 1 1 1 2 5\\n2 2 2 1 1 2 3 5\\n3 2 2 1 1 3 4 5\\n"
                "4 2 2 1 1 4 1 5\\n5 1 2 2 2 2 3\\n$EndElements\\n")
    else:
        body = ("$Nodes\\n4\\n1 0 0 0\\n2 1 0 0\\n3 1 1 0\\n4 0 1 0\\n"
                "$EndNodes\\n$Elements\\n3\\n1 2 2 1 1 1 2 3\\n"
                "2 2 2 1 1 1 3 4\\n3 1 2 2 2 2 3\\n$EndElements\\n")
    open(out, "w").write(header + body)
''')

MOCK_FLOW123D = textwrap.dedent('''\
    #!/usr/bin/env python3
    """Mock flow123d: outflow flux := -mean(conductivity over elements).
    Self-contained $ElementData parse (no heavyweight imports: the pool
    spawns one solver process per sub-sample)."""
    import os, sys
    args = sys.argv[1:]
    indir = args[args.index("-i") + 1]
    outdir = args[args.index("-o") + 1]
    values = []
    with open(os.path.join(indir, "fields_sample.msh")) as f:
        lines = iter(f.read().splitlines())
        for line in lines:
            if line.strip() == "$ElementData":
                for _ in range(int(next(lines))): next(lines)   # strings
                for _ in range(int(next(lines))): next(lines)   # reals
                n_int = int(next(lines))
                ints = [int(next(lines)) for _ in range(n_int)]
                for _ in range(ints[2]):
                    values.append(float(next(lines).split()[1]))
    flux = -sum(values) / len(values)
    open(os.path.join(outdir, "water_balance.yaml"), "w").write(
        "data:\\n- {time: 0, region: .bc_outflow, data: [%r, 0.0]}\\n" % flux)
''')


def write_executable(path, text):
    with open(path, "w") as f:
        f.write(text)
    os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR)


def main():
    work = tempfile.mkdtemp(prefix="flow_sim_example_")
    gmsh = os.path.join(work, "mock_gmsh")
    flow = os.path.join(work, "mock_flow123d")
    write_executable(gmsh, MOCK_GMSH)
    write_executable(flow, MOCK_FLOW123D)

    geo = os.path.join(work, "square.geo")
    with open(geo, "w") as f:
        f.write("// unit square (consumed by the mock)\n")
    tmpl = os.path.join(work, "flow_input.yaml.tmpl")
    with open(tmpl, "w") as f:
        f.write("mesh: <mesh_file>\ntime_step: <timestep_h1>\n"
                "conductivity: <conductivity>\n")

    sim = FlowSim(dict(
        env={"gmsh": gmsh, "flow123d": flow, "gmsh_version": 2},
        fields_params=dict(model="exp", corr_length=0.3, dim=2,
                           log=True, sigma=1.0, mode_no=128),
        yaml_file=tmpl, geo_file=geo,
        work_dir=os.path.join(work, "levels")), clean=True)

    storage = Memory()
    sampler = Sampler(storage, ThreadPool(2, work_dir=os.path.join(work, "out")),
                      sim, level_parameters=[[0.6], [0.2]])
    sampler.set_initial_n_samples([16, 8])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    print("collected per level:", list(storage.get_n_collected()))

    root = make_root_quantity(storage, q_specs=sim.result_format())
    flux = root["conductivity"][1]["0"][0]
    domain = est_mod.Estimate.estimate_domain(flux, storage, quantile=0.01)
    est = est_mod.Estimate(flux, storage, Legendre(8, domain))
    means, variances = est.estimate_moments()
    print("telescoped flux moments[:4]:", np.round(np.asarray(means[:4]), 5))
    print("workspace kept at:", work)


if __name__ == "__main__":
    main()
