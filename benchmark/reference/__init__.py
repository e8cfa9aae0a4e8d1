"""The plain references: each a module of this folder, in plain PyTorch,
with no kernel of the program, imported by nothing of the program and
importing none of it.

A configuration file names its reference by path (``"reference":
"benchmark/reference/<name>.py"``, a file directly in this folder); the
cell loads that module by name (``cells.reference``), so that a
configuration whose equations differ brings its reference as a file added.
The drivers call these names of it, and no others:

- ``param_shapes(model, max_id, out_channels)``: ``{name: (shape, kind)}``
  of every parameter, named as the program's ``state_dict`` keys; a kind
  is ``linear:<fan in>``, ``embedding``, ``norm_one`` or ``norm_zero``
  (``generate.make_weights`` draws each kind).
- ``Adjacency(edge_index, n, aggr)``: the normalized adjacency of a
  (2, E) directed edge list on the device, from the edges alone; raises
  ``NotImplementedError`` for an ``aggr`` it does not have.
- ``precision(tf32)``: a context manager under which the products run in
  f32 with TF32 off (``False``, the reference) or on (``True``, the
  control).
- ``train_steps(params, model, adj, ids, batches, dropout_seed, *,
  half_batch=False)``: the steps of training from ``params`` over
  ``batches`` of (pos, y), the dropout masks drawn as the program draws
  them from ``dropout_seed``; a dict of ``losses`` (a float a step),
  ``first_grad`` and ``params`` (after the last step), each ``{name:
  tensor}``. ``half_batch`` plants the fault of a loss over the first
  half of each batch only.
- ``predict(params, model, adj, ids, pos)``: the (B, C) inference logits
  of the subgraphs ``pos`` (padded with -1).
- ``norm(t)``: a tensor's 2-norm as a float, in f64.
- ``BETAS``: Adam's (beta1, beta2), by which the training driver reads
  the program's first gradient from Adam's first moment.
"""

NAMES = ("param_shapes", "Adjacency", "precision", "train_steps", "predict",
         "norm", "BETAS")
