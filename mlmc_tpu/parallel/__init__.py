from mlmc_tpu.parallel.mesh import SampleMesh, sample_mesh
from mlmc_tpu.parallel.sharded_estimate import (
    sharded_mlmc_step, sharded_synth_pipeline_from_noise)
