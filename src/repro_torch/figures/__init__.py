"""The paper-figure scripts of the port: Figs. 3, 4 and 5, the §6
efficiency table and the beyond-paper figures (``fig_churn``,
``fig_decode``, ``fig_transport``, ``fig_fleet``), through
:class:`repro_torch.core.engine.Engine`.

    PYTHONPATH=src python -m repro_torch.figures.run              # on the card
    PYTHONPATH=src python -m repro_torch.figures.run --smoke --device cpu

The port's counterpart of the reference's ``benchmarks/{fig3,fig4,fig5,
efficiency,fig_churn,fig_decode,fig_transport,fig_fleet}.py``: the same
rows (the beyond-paper figures add each run's horizon ``M``), summaries
and default sweeps, written as
``{"meta", "data"}`` JSON to ``build/repro_torch/figures/`` (``--out``).
"""
