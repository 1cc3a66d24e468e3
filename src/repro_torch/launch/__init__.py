"""Entry points of the port: ``python -m repro_torch.launch.serve``,
``.train``, and the production-mesh dry run ``.dryrun`` / ``.recost``
(device meshes: :mod:`repro_torch.launch.mesh`)."""
