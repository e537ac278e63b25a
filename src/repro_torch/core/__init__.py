"""The pieces of the AdaPM core the serving path uses: Algorithm 1 action
timing, streaming intent and the §4.1 window classifiers."""
