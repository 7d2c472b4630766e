from emr2a_tpu_torch.pipelines.step3_retrieval.evaluate_retrieval import main

if __name__ == "__main__":
    main()
