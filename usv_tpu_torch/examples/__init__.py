"""The counterparts of the repo-root ``examples/`` scripts, run through the
port: ``eval_aitsmc``, ``population_sweep``, ``reward_explore``. Each writes
the data behind its figure as JSON; the figure is drawn where matplotlib is
installed."""
