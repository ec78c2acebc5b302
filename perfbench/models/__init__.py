"""Model kinds, found by name.

A configuration file names its kind (``"model": "<kind>"``), and the
harness loads ``perfbench/models/<kind>.py`` by path, as it loads
``readers/<metric>.py``.  A kind module provides every function of
``harness.KIND_FUNCS``:

* ``spec(conf, shrink)``: the model's shape from the configuration
  file (``shrink``'s keys replaced, the CPU rehearsal's sizes); it holds
  ``vocab``, which the traffic draws its tokens from;
* ``model_config(conf, spec)``: the port's ``ModelConfig`` of it;
* ``make_weights(spec, seed, device)``, ``copy_weights(w)`` and
  ``engine_params(spec, w)``: weights drawn on the device from the seed,
  a second engine's copy, and the param tree ``ServeEngine`` takes;
* ``weight_bytes(spec)`` and ``page_bytes(spec, page_size)``: one
  engine's weights and one page of every layer's KV pools
  (``size_pool.py``);
* ``logits_at(weights, spec, seqs, firsts, precision)``: the plain
  float32 reference (``precision="fp32"``) and its ``"fp8"`` control;
* ``flops(spec, first, last)``: model FLOPs of computing positions
  ``first .. last - 1`` of one sequence (``mfu.open``).

A kind imports neither JAX nor ``repro``; it reaches the port only
inside ``model_config``, and its reference reaches nothing of the port.
"""
