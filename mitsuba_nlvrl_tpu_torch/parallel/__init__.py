"""Rendering of film-position wavefronts (port of
``mitsuba_nlvrl_tpu/parallel/``). This slice has ``render_wavefront``;
the sharded renders wait for the multi-GPU port."""
