from lighthouse2_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh, render_pass_sharded, replicate_scene, train_step_sharded,
)
