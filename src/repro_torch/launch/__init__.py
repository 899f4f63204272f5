"""The port's entry points: training (`train`), serving (`serve`), the
step builders (`steps`), process groups and meshes (`mesh`) and the
sharding plan's dry run (`dryrun`)."""
