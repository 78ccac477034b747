"""Dense multi-view stereo and surface reconstruction (port of
`tpu3drec/mvs/`), the dense half of the reference's MVE pipeline:

- `plane_sweep`: per-view dense depth by plane-sweep ZNCC stereo;
- `tsdf`: voxel-centric TSDF fusion of the per-view depth maps;
- `marching`: marching-tetrahedra isosurface extraction;
- `meshclean`: connected-component floater removal on the host.

Pipeline entry point: `tpu3drec_torch.pipelines.mvs.run_mvs` / the CLI's `mvs`.
"""
