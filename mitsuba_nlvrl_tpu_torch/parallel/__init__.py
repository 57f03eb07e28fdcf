"""Multi-rank rendering on ``torch.distributed`` (port of
``mitsuba_nlvrl_tpu/parallel/``): the data-parallel render
(``render_dist``), photon and VRL maps sharded over a map axis
(``sharded_maps``), the scaling harness and process-group entry
(``scaling``), and the collectives they share (``collectives``)."""
